"""R3D: 3D ResNets (18/34/50/101/152) for Crowd-11.

Counterpart of `crowded_scenes_ensemble_classification_tpu/models/r3d.py`
(reference keras-resnet3d, train.py:1278-1559): pre-activation residual
blocks (BN → ReLU → conv, convs with bias), a 7³/2 TF-SAME stem conv with
BN + ReLU and a 3³/2 TF-SAME max pool, four stages that double the
channels (stride 2 in the first block of every stage but the first), a
projection shortcut where shape or channels change, a final BN + ReLU, a
full-volume average pool and Dense.  Attribute names follow the flax tree
(`stage2_block0.shortcut.proj`), so `models/convert.py` maps a flax
checkpoint key for key.  Takes NTHWC clips and returns float32 logits.

The stem conv stays cuDNN: it is an `nn.Conv` in JAX (r3d.py:151), not the
I3D stem kernel.  The Keras l2(1e-4) on every conv and dense kernel is
`models/common.l2_param_penalty`, which the train steps add to R3D's loss
(`train/engine.R3D_L2_WEIGHT`); `SameConv3d` is an `nn.Conv3d`, so every
conv here, the shortcut projections too, is counted.

With `quant` (inference only; JAX r3d.py:39-47) every conv, the stem, the
strided 3³ convs and the 1³/2 VALID projections included, is a
`models/common.QuantConv` with its bias on the int8 kernel.  Its f32 output
goes through the next BN + ReLU in f32, cast to `dtype` after, and a block's
residual sum is f32, as in the JAX modules.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import BNRelu, QuantConv, conv3d_same, lecun_normal_, max_pool_3d, quant_mode, to_ncdhw

# depth → (block kind, repetitions) (JAX models/r3d.py:30-37, reference
# train.py:1526-1559)
R3D_PRESETS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


class SameConv3d(nn.Conv3d):
    """Conv3d with bias and TF-SAME padding, flax's lecun-normal init and
    zero bias (JAX models/r3d.py:40-57)."""

    def __init__(self, c_in: int, c_out: int, kernel, strides=(1, 1, 1), generator=None):
        super().__init__(c_in, c_out, kernel, stride=strides)
        lecun_normal_(self.weight, c_in * math.prod(self.kernel_size), generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x.dtype: the f32 master weights of a trainable model, cast
        return conv3d_same(x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.stride)


def _conv(c_in: int, c_out: int, kernel, strides=(1, 1, 1), generator=None, quant=False, padding="SAME"):
    """A `SameConv3d`, or with `quant` its int8 stand-in (JAX r3d.py:39-57)."""
    if quant:
        return QuantConv(c_in, c_out, kernel, strides, padding, mode=quant_mode(quant), generator=generator)
    return SameConv3d(c_in, c_out, kernel, strides, generator=generator)


class _Shortcut(nn.Module):
    """Identity, or a 1×1×1 VALID projection when shape or channels change
    (JAX models/r3d.py:60-83, reference `_shortcut3d` train.py:1324-1346).
    Whether it projects is known when the block is built; its strides come
    from the two shapes in `forward`, ceil(x/residual) per axis, as in JAX."""

    def __init__(self, c_in: int, c_out: int, projection: bool, generator=None, quant=False):
        super().__init__()
        self.proj = _conv(c_in, c_out, (1, 1, 1), generator=generator, quant=quant, padding="VALID") \
            if projection else None

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        strides = tuple(math.ceil(int(a) / int(b)) for a, b in zip(x.shape[2:], residual.shape[2:]))
        if isinstance(self.proj, QuantConv):
            x = self.proj(x, strides)
        elif self.proj is not None:
            x = F.conv3d(x, self.proj.weight.to(x.dtype), self.proj.bias.to(x.dtype), stride=strides)
        elif strides != (1, 1, 1) or x.shape[1] != residual.shape[1]:
            raise ValueError(f"identity shortcut between shapes {tuple(x.shape)} and {tuple(residual.shape)}")
        return x + residual


def _projects(c_in: int, c_out: int, strides) -> bool:
    return any(s > 1 for s in strides) or c_in != c_out


class BasicBlock3D(nn.Module):
    """Two 3³ convs (JAX models/r3d.py:86-106).  The first block of the first
    stage skips `preact1`: the stem just ran BN + ReLU + pool."""

    expansion = 1

    def __init__(self, c_in: int, features: int, strides=(1, 1, 1), is_first_block_of_first_layer: bool = False,
                 generator=None, quant=False):
        super().__init__()
        g, q = generator, quant
        self.preact1 = None if is_first_block_of_first_layer else BNRelu(c_in)
        self.conv1 = _conv(c_in, features, (3, 3, 3), strides, generator=g, quant=q)
        self.preact2 = BNRelu(features)
        self.conv2 = _conv(features, features, (3, 3, 3), generator=g, quant=q)
        self.shortcut = _Shortcut(c_in, features, _projects(c_in, features, strides), generator=g, quant=q)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """`dtype`: what each BN + ReLU casts to (the model's working dtype)."""
        y = self.conv1(x if self.preact1 is None else self.preact1(x, dtype))
        y = self.conv2(self.preact2(y, dtype))
        return self.shortcut(x, y)


class BottleneckBlock3D(nn.Module):
    """1³ → 3³ → 1³ (×4 channels) (JAX models/r3d.py:109-128); the first
    block of the first stage skips `preact1`."""

    expansion = 4

    def __init__(self, c_in: int, features: int, strides=(1, 1, 1), is_first_block_of_first_layer: bool = False,
                 generator=None, quant=False):
        super().__init__()
        g, q = generator, quant
        self.preact1 = None if is_first_block_of_first_layer else BNRelu(c_in)
        self.conv1 = _conv(c_in, features, (1, 1, 1), strides, generator=g, quant=q)
        self.preact2 = BNRelu(features)
        self.conv2 = _conv(features, features, (3, 3, 3), generator=g, quant=q)
        self.preact3 = BNRelu(features)
        self.conv3 = _conv(features, 4 * features, (1, 1, 1), generator=g, quant=q)
        self.shortcut = _Shortcut(c_in, 4 * features, _projects(c_in, 4 * features, strides), generator=g, quant=q)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        y = self.conv1(x if self.preact1 is None else self.preact1(x, dtype))
        y = self.conv2(self.preact2(y, dtype))
        y = self.conv3(self.preact3(y, dtype))
        return self.shortcut(x, y)


class R3D(nn.Module):
    """ResNet3D classifier (JAX models/r3d.py:131-177), `depth` ∈ R3D_PRESETS.
    `width` shrinks every stage (base = max(int(64·width), 8); width 1 is
    the reference topology).  `compute_dtype`, when set, is the dtype the
    model computes in while its weights stay in theirs (as `I3D`).  `quant`
    (True or 'dynamic', 'calib', 'static') runs every conv in int8,
    inference only."""

    def __init__(
        self,
        num_classes: int = 11,
        depth: int = 18,
        width: float = 1.0,
        generator: Optional[torch.Generator] = None,
        quant: Union[bool, str] = False,
    ):
        super().__init__()
        if depth not in R3D_PRESETS:
            raise ValueError(f"R3D depth must be one of {sorted(R3D_PRESETS)}, got {depth}")
        kind, repetitions = R3D_PRESETS[depth]
        block_cls = BasicBlock3D if kind == "basic" else BottleneckBlock3D
        g = generator
        base = max(int(64 * width), 8)
        self.conv1 = _conv(3, base, (7, 7, 7), (2, 2, 2), generator=g, quant=quant)
        self.stem_bnrelu = BNRelu(base)
        self.block_names: Tuple[str, ...] = ()
        c_in, features = base, base
        for stage, reps in enumerate(repetitions):
            for i in range(reps):
                strides = (2, 2, 2) if (i == 0 and stage != 0) else (1, 1, 1)
                name = f"stage{stage}_block{i}"
                setattr(self, name, block_cls(c_in, features, strides, stage == 0 and i == 0, generator=g,
                                              quant=quant))
                self.block_names += (name,)
                c_in = features * block_cls.expansion
            features *= 2
        self.final_bnrelu = BNRelu(c_in)
        self.quant = quant
        self.predictions = nn.Linear(c_in, num_classes)
        lecun_normal_(self.predictions.weight, c_in, g)
        nn.init.zeros_(self.predictions.bias)
        self.compute_dtype: Optional[torch.dtype] = None

    @property
    def dtype(self) -> torch.dtype:
        """The working dtype: `compute_dtype`, else that of the weights."""
        return self.compute_dtype or self.conv1.weight.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if self.quant and self.training:
            raise ValueError("quant R3D is inference-only")
        x = self.stem_bnrelu(self.conv1(to_ncdhw(x.to(dt))), dt)
        x = max_pool_3d(x, (3, 3, 3), (2, 2, 2))
        for name in self.block_names:
            x = getattr(self, name)(x, dt)
        x = self.final_bnrelu(x, dt)
        # Full-volume average pool (reference train.py:1502-1507), in float32
        # as I3D's head averages.
        x = x.float().mean(dim=(2, 3, 4)).to(dt)
        return F.linear(x, self.predictions.weight.to(dt), self.predictions.bias.to(dt)).float()

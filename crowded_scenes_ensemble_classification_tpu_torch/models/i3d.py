"""Inflated Inception-v1 (I3D) for Crowd-11.

Counterpart of `crowded_scenes_ensemble_classification_tpu/models/i3d.py`.
Module and attribute names follow the flax tree (`trunk.Mixed_3b.b0_1x1.conv`),
so `models/convert.py` maps a flax checkpoint key for key.

The 3³/1 pool branch of every Mixed_* block runs the hand-written kernel
`ops/kernels/maxpool.max_pool_3x3x3_same` (the JAX `pool_impl='pallas'`
route, i3d.py:158-170); there is no switch, and its gradient is a
hand-written kernel too.  `stem_impl='pallas'` runs the stem's conv on the
hand-written kernel `ops/kernels/stem_conv`, in eval and train mode.

`quant` (True or 'dynamic', 'calib', 'static') runs the convs in int8 on
the hand-written int8 kernel (`models/common.QuantConv`), inference only;
`quant_blocks` limits it to the named sites (`models/quantize`).  The pool
branch stays on the max-pool kernel, unquantized, and the kernel stem
(`stem_impl='pallas'`) and the s2d stem take no quant, as in JAX
(i3d.py:255-267).

`fuse_1x1` runs each block's three 1³ convs that read the block input as
one conv of their concatenated kernels (a cuDNN conv; in static int8 one
quantize pass and one launch of the int8 kernel), with the state dict
unchanged.  `remat` / `remat_blocks` rematerialise the Mixed blocks in the
backward pass (`models/common.remat_call`).

`I3DKinetics` is the with-top Kinetics classifier that Keras-layout
Kinetics checkpoints load into (`models/weights_io.py`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels.maxpool import max_pool_3x3x3_same
from .c3d import dropout
from .common import (
    ConvBN,
    ExternalConvBN,
    ExternalQuantConvBN,
    PallasStemConvBN,
    PrestagedS2DStemConvBN,
    S2DStemConvBN,
    _QuantBuffers,
    _static_conv,
    avg_pool_3d,
    conv3d_same,
    flatten,
    lecun_normal_,
    max_pool_3d,
    remat_call,
    static_operands,
    to_ncdhw,
    to_nthwc,
)
from .quantize import resolve_quant_blocks

# (b0_1x1, b1_1x1, b1_3x3, b2_1x1, b2_3x3, b3_pool_proj) per block
# (JAX models/i3d.py:48-58).
INCEPTION_SPECS = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),
    "Mixed_3c": (128, 128, 192, 32, 96, 64),
    "Mixed_4b": (192, 96, 208, 16, 48, 64),
    "Mixed_4c": (160, 112, 224, 24, 64, 64),
    "Mixed_4d": (128, 128, 256, 24, 64, 64),
    "Mixed_4e": (112, 144, 288, 32, 64, 64),
    "Mixed_4f": (256, 160, 320, 32, 128, 128),
    "Mixed_5b": (256, 160, 320, 32, 128, 128),
    "Mixed_5c": (384, 192, 384, 48, 128, 128),
}
# Blocks in order, with the TF-SAME max pool that precedes each group
# (JAX models/i3d.py:273-280).
_BLOCK_GROUPS = (
    (None, ("Mixed_3b", "Mixed_3c")),
    (((3, 3, 3), (2, 2, 2)), ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f")),
    (((2, 2, 2), (2, 2, 2)), ("Mixed_5b", "Mixed_5c")),
)
TRUNK_FEATURES = 1024
RGB_CHANNELS = 3


def block_out_features(spec: Tuple[int, ...]) -> int:
    b0, _, b1, _, b2, b3 = spec
    return b0 + b1 + b2 + b3


class InceptionBlock(_QuantBuffers, nn.Module):
    """One Mixed_* block on NCDHW: 4 branches concatenated on channels
    (JAX models/i3d.py:61-172).

    `fuse_1x1` (JAX i3d.py:111-151) runs the three 1³ convs that read the
    block input (b0_1x1, b1_1x1, b2_1x1) as one conv whose kernel is their
    concatenation on the output axis, and each branch's slice through its
    own BatchNorm + ReLU; the branches are `ExternalConvBN`s, so the state
    dict equals the unfused block's.  Unquantized it is one conv in the
    block's dtype, trainable.  With the three sites in 'static' int8 the
    block input is quantized once under the max of their `act_absmax` and
    one int8 conv runs over the concatenated k8 and sw
    (`ExternalQuantConvBN.quant_state`): bit for bit the unfused block's
    when the three were calibrated on the same input, as they are.  Its
    packed weights and scales are held as non-persistent buffers, computed
    from the branches' state when they turn static, are baked or loaded
    (`refresh_static_operands`), as a QuantConv holds its own.  'dynamic'
    and 'calib' run unfused, as JAX's block falls through."""

    def __init__(self, in_features: int, spec, generator: Optional[torch.Generator] = None,
                 quant: Union[bool, str] = False, fuse_1x1: bool = False):
        super().__init__()
        b0_c, b1_r, b1_c, b2_r, b2_c, b3_c = spec
        g, q = generator, quant
        inputs = ExternalQuantConvBN if fuse_1x1 and quant else ExternalConvBN if fuse_1x1 else ConvBN
        self.b0_1x1 = inputs(in_features, b0_c, (1, 1, 1), generator=g, quant=q)
        self.b1_1x1 = inputs(in_features, b1_r, (1, 1, 1), generator=g, quant=q)
        self.b1_3x3 = ConvBN(b1_r, b1_c, (3, 3, 3), generator=g, quant=q)
        self.b2_1x1 = inputs(in_features, b2_r, (1, 1, 1), generator=g, quant=q)
        self.b2_3x3 = ConvBN(b2_r, b2_c, (3, 3, 3), generator=g, quant=q)
        self.b3_1x1 = ConvBN(in_features, b3_c, (1, 1, 1), generator=g, quant=q)
        self.fuse_1x1 = fuse_1x1
        self.quant = quant
        self.widths = (b0_c, b1_r, b2_r)
        if fuse_1x1 and quant:
            self._register_static_operands()

    def _inputs(self):
        return self.b0_1x1, self.b1_1x1, self.b2_1x1

    def _fused_static(self) -> bool:
        return self.fuse_1x1 and bool(self.quant) and all(b.conv.quant_mode == "static" for b in self._inputs())

    def _static_sources(self) -> Optional[tuple]:
        """The branches' baked k8, sw and act_absmax, or None where a branch
        is not static or not baked (then the fused operands are computed
        in each call, from the weights quantized there)."""
        if not self._fused_static() or any(b.conv.k8 is None for b in self._inputs()):
            return None
        return tuple(t for b in self._inputs() for t in b.quant_state())

    def _compute_static_operands(self) -> tuple:
        """`static_operands` of the concatenated kernel: k8 and sw
        concatenated on the output axis, then packed as one kernel (each
        packed buffer is padded apart), under the max of the three
        act_absmax (JAX i3d.py:119-125)."""
        k8, sw, act = zip(*(b.quant_state() for b in self._inputs()))
        act = torch.maximum(torch.maximum(act[0], act[1]), act[2])
        return static_operands(torch.cat(k8), torch.cat(sw), act / 127.0)

    def _fused_inputs(self, x: torch.Tensor) -> list:
        """The three input branches' outputs from one conv (module docstring)."""
        if self.quant:
            if self.training:
                raise ValueError("quant ConvBN is inference-only")
            ops = self.held_static_operands() if self._static_sources() is not None else \
                self._compute_static_operands()
            y = _static_conv(to_nthwc(x), ops, None, (1, 1, 1), (1, 1, 1), "SAME")  # f32 NTHWC
        else:
            w = torch.cat([b.kernel_value() for b in self._inputs()]).to(x.dtype)
            y = to_nthwc(conv3d_same(x, w, None, (1, 1, 1)))
        outs, start = [], 0
        for b, width in zip(self._inputs(), self.widths):
            part = to_ncdhw(y[..., start:start + width].contiguous())  # channels_last_3d, as an unfused conv's
            outs.append(b.bn_relu(part, x.dtype) if self.quant else b.bn_relu(part))
            start += width
        return outs

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fuse_1x1 and (not self.quant or self._fused_static()):
            branch_0, branch_1, branch_2 = self._fused_inputs(x)
            branch_1, branch_2 = self.b1_3x3(branch_1), self.b2_3x3(branch_2)
        else:
            branch_0 = self.b0_1x1(x)
            branch_1 = self.b1_3x3(self.b1_1x1(x))
            branch_2 = self.b2_3x3(self.b2_1x1(x))
        branch_3 = to_ncdhw(max_pool_3x3x3_same(to_nthwc(x)))
        branch_3 = self.b3_1x1(branch_3)
        return torch.cat([branch_0, branch_1, branch_2, branch_3], dim=1)


class I3DTrunk(nn.Module):
    """Stem + Mixed_3b..Mixed_5c on NCDHW (JAX models/i3d.py:175-281).

    The stem, in the order of precedence of JAX i3d.py:255-267:
    stem_prestaged=True takes the `s2d_stem_stage` layout (NTHWC, 4C
    channels), computed once per batch and shared by ensemble members;
    stem_impl='pallas' runs the hand-written stem kernel on NTHWC clips
    ('auto' is the default and does not; the JAX trunk drops its Pallas stem
    in train mode, the port keeps its kernel); s2d_stem=True
    runs the exact s2d rewrite; otherwise the canonical 7³/2 ConvBN.  Every
    stem holds the same `Conv3d_1a_7x7` state.  `channels` is the input's:
    3 for RGB, 2 for TwoStream's flow trunk.  `quant` applies at every site
    (the three stem convs and the nine Mixed blocks) or, with
    `quant_blocks`, at the named ones (JAX i3d.py:240-244).  `fuse_1x1`
    fuses every block's input 1³ convs (`InceptionBlock`).  remat=True
    rematerialises all nine Mixed blocks in the backward pass, and
    `remat_blocks` only the named ones (names of no block are ignored, as
    in JAX); neither goes with `quant` (JAX i3d.py:231-234)."""

    def __init__(
        self,
        stem_prestaged: bool = False,
        s2d_stem: bool = False,
        stem_impl: str = "auto",
        generator: Optional[torch.Generator] = None,
        channels: int = RGB_CHANNELS,
        quant: Union[bool, str] = False,
        quant_blocks=None,
        fuse_1x1: bool = False,
        remat: bool = False,
        remat_blocks=None,
    ):
        super().__init__()
        if stem_impl not in ("auto", "pallas"):
            raise ValueError(f"stem_impl must be 'auto' or 'pallas', got {stem_impl!r}")
        if quant and (remat or remat_blocks):
            raise ValueError("quant=True is incompatible with remat")
        self.remat_blocks = frozenset(name for _, names in _BLOCK_GROUPS for name in names
                                      if remat or (remat_blocks is not None and name in remat_blocks))
        g = generator
        blocks = resolve_quant_blocks(quant_blocks)
        site_quant = lambda name: quant if blocks is None or name in blocks else False  # noqa: E731
        self.stem_prestaged = stem_prestaged
        if stem_prestaged:
            self.Conv3d_1a_7x7 = PrestagedS2DStemConvBN(channels, 64, generator=g,
                                                        quant=site_quant("Conv3d_1a_7x7"))
        elif stem_impl == "pallas":
            self.Conv3d_1a_7x7 = PallasStemConvBN(channels, 64, generator=g)
        elif s2d_stem:
            self.Conv3d_1a_7x7 = S2DStemConvBN(channels, 64, generator=g)
        else:
            self.Conv3d_1a_7x7 = ConvBN(channels, 64, (7, 7, 7), (2, 2, 2), generator=g,
                                        quant=site_quant("Conv3d_1a_7x7"))
        self.Conv3d_2b_1x1 = ConvBN(64, 64, (1, 1, 1), generator=g, quant=site_quant("Conv3d_2b_1x1"))
        self.Conv3d_2c_3x3 = ConvBN(64, 192, (3, 3, 3), generator=g, quant=site_quant("Conv3d_2c_3x3"))
        features = 192
        for _, names in _BLOCK_GROUPS:
            for name in names:
                setattr(self, name, InceptionBlock(features, INCEPTION_SPECS[name], generator=g,
                                                   quant=site_quant(name), fuse_1x1=fuse_1x1))
                features = block_out_features(INCEPTION_SPECS[name])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stem_prestaged:
            x = self.Conv3d_1a_7x7(x)
        else:
            x = self.Conv3d_1a_7x7(to_ncdhw(x))
        x = max_pool_3d(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2b_1x1(x)
        x = self.Conv3d_2c_3x3(x)
        x = max_pool_3d(x, (1, 3, 3), (1, 2, 2))
        for pool, names in _BLOCK_GROUPS:
            if pool is not None:
                x = max_pool_3d(x, *pool)
            for name in names:
                block = getattr(self, name)
                x = remat_call(block, x) if name in self.remat_blocks else block(x)
        return x


def i3d_feature_head(x: torch.Tensor) -> torch.Tensor:
    """include_top=False head on NCDHW: AvgPool3D((2, h, w), stride 1,
    VALID) (JAX models/i3d.py:284-288), averaged in float32."""
    h, w = int(x.shape[3]), int(x.shape[4])
    return avg_pool_3d(x.float(), (2, h, w), (1, 1, 1))


def head_features(frames: int) -> int:
    """Dense input width for clips of `frames` frames: the trunk halves time
    three times with TF-SAME rounding (stem, two pools), the head averages
    pairs of the frames left and all of H×W."""
    t = math.ceil(math.ceil(math.ceil(frames / 2) / 2) / 2)
    return (t - 1) * TRUNK_FEATURES


class I3D(nn.Module):
    """Single-stream I3D classifier: trunk → feature head → Flatten in
    (T', H', W', C) order → Dense(num_classes) (JAX models/i3d.py:291-331).
    Takes NTHWC clips (or, with stem_prestaged, their s2d staging) and
    returns float32 logits.  stem_impl and s2d_stem pick the stem
    (`I3DTrunk`).  `compute_dtype`, when set, is the dtype the model
    computes in while its weights stay in theirs (f32 master weights, each
    cast in the forward, as the JAX dtype/param_dtype pair); None computes
    in the weights' dtype.  `quant` and `quant_blocks` quantize the trunk's
    convs (`I3DTrunk`); a quantized model keeps its conv weights in f32 and
    computes in `compute_dtype` (`models.registry.build_model`).
    `fuse_1x1`, `remat` and `remat_blocks` go to the trunk."""

    def __init__(
        self,
        num_classes: int = 11,
        frames: int = 20,
        stem_prestaged: bool = False,
        s2d_stem: bool = False,
        stem_impl: str = "auto",
        generator: Optional[torch.Generator] = None,
        quant: Union[bool, str] = False,
        quant_blocks=None,
        fuse_1x1: bool = False,
        remat: bool = False,
        remat_blocks=None,
    ):
        super().__init__()
        self.stem_prestaged = stem_prestaged
        self.trunk = I3DTrunk(stem_prestaged, s2d_stem, stem_impl, generator=generator, quant=quant,
                              quant_blocks=quant_blocks, fuse_1x1=fuse_1x1, remat=remat, remat_blocks=remat_blocks)
        features = head_features(frames)
        self.predictions = nn.Linear(features, num_classes)
        lecun_normal_(self.predictions.weight, features, generator)
        nn.init.zeros_(self.predictions.bias)
        self.compute_dtype: Optional[torch.dtype] = None

    @property
    def dtype(self) -> torch.dtype:
        """The working dtype: `compute_dtype`, else that of the conv weights
        (`cast_for_inference`)."""
        return self.compute_dtype or self.trunk.Conv3d_1a_7x7.conv.weight.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = self.trunk(x.to(dt))
        x = flatten(i3d_feature_head(x)).to(dt)
        return F.linear(x, self.predictions.weight.to(dt), self.predictions.bias.to(dt)).float()


class I3DKinetics(nn.Module):
    """The include_top Kinetics I3D (JAX models/i3d.py:334-360, reference
    train.py:1196-1213), for converting and checking Kinetics checkpoints:
    the trunk (canonical stem; its pool branches on the max-pool kernel) →
    AvgPool3D (2, 7, 7) VALID → dropout (train mode, masks from
    `generator`) → `Conv3d_6a_1x1`, a 1×1×1 conv with a bias and no BN or
    ReLU → the mean over the frames (and over H×W, which is 1×1 at the
    224² input the pool is built for) → float32 logits.  The smallest clip
    the pool admits is 9 × 193²."""

    def __init__(self, num_classes: int = 400, dropout_rate: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.trunk = I3DTrunk(generator=generator)
        self.Conv3d_6a_1x1 = nn.ModuleDict({"conv": nn.Conv3d(TRUNK_FEATURES, num_classes, 1)})
        lecun_normal_(self.Conv3d_6a_1x1["conv"].weight, TRUNK_FEATURES, generator)
        nn.init.zeros_(self.Conv3d_6a_1x1["conv"].bias)
        self.dropout_rate = dropout_rate
        self.compute_dtype: Optional[torch.dtype] = None

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.trunk.Conv3d_1a_7x7.conv.weight.dtype

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.dtype
        x = avg_pool_3d(self.trunk(x.to(dt)).float(), (2, 7, 7))
        if self.training and self.dropout_rate:
            x = dropout(x, self.dropout_rate, generator)
        conv = self.Conv3d_6a_1x1["conv"]
        x = F.conv3d(x.to(dt), conv.weight.to(dt), conv.bias.to(dt))
        return x.float().mean(dim=(2, 3, 4))

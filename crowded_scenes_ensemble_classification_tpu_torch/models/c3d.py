"""C3D (Tran et al. 2015) for Crowd-11.

Counterpart of `crowded_scenes_ensemble_classification_tpu/models/c3d.py`
(reference `ConvNets3D`, train.py:1224-1273): 8 convs with bias, 5 VALID
max pools, a zero pad after H and W before pool5, fc6/fc7 with dropout
and fc8.  Attribute names follow the flax tree (`conv3a`, `fc6`), so
`models/convert.py` maps a flax checkpoint key for key.  Takes NTHWC clips
and returns float32 logits.  With `quant` (inference only) every conv is a
`models/common.QuantConv` with its bias on the int8 kernel: its f32 output
stays f32 through ReLU and pools into the next conv, and only the Dense
layers compute in `dtype` (JAX models/c3d.py:38-53).

Dropout (train mode only) draws its masks from the `generator` given to
`forward`, never from torch's global RNG: the train steps seed one per step
from (state.seed, state.step) on the module's device, as JAX derives its
dropout key from (state.rng, state.step), so a resumed run draws the masks
an uninterrupted one would.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import QuantConv, flatten, lecun_normal_, max_pool_3d, quant_mode, to_ncdhw

# (name, features at width 1, VALID pool after it or None) in order
# (JAX models/c3d.py:65-84).
_CONVS = (
    ("conv1", 64, (1, 2, 2)),
    ("conv2", 128, (2, 2, 2)),
    ("conv3a", 256, None),
    ("conv3b", 256, (2, 2, 2)),
    ("conv4a", 512, None),
    ("conv4b", 512, (2, 2, 2)),
    ("conv5a", 512, None),
    ("conv5b", 512, "pad+pool"),
)
FC_FEATURES = 4096


def c3d_flat_features(clip_thw: Tuple[int, int, int], features: int) -> int:
    """fc6's input width for clips of (T, H, W): flax sizes fc6 from the
    input, the port from the clip geometry it is built for.  1·4·4·512 =
    8192 at 16×112² and width 1."""
    t, h, w = clip_thw
    h, w = h // 2, w // 2  # pool1 (1, 2, 2)
    for _ in range(3):  # pool2-4 (2, 2, 2)
        t, h, w = t // 2, h // 2, w // 2
    t, h, w = t // 2, (h + 1) // 2, (w + 1) // 2  # zero pad (0, 1) on H and W, pool5
    if min(t, h, w) < 1:
        raise ValueError(f"C3D needs clips of at least 16x32x32, got {clip_thw}")
    return t * h * w * features


def _conv(c_in: int, c_out: int, generator, quant=False) -> nn.Conv3d:
    """3³ stride-1 conv with bias: TF-SAME is a symmetric pad of 1."""
    if quant:
        return QuantConv(c_in, c_out, (3, 3, 3), mode=quant_mode(quant), generator=generator)
    conv = nn.Conv3d(c_in, c_out, 3, padding=1)
    lecun_normal_(conv.weight, c_in * 27, generator)
    nn.init.zeros_(conv.bias)
    return conv


def _dense(c_in: int, c_out: int, generator) -> nn.Linear:
    dense = nn.Linear(c_in, c_out)
    lecun_normal_(dense.weight, c_in, generator)
    nn.init.zeros_(dense.bias)
    return dense


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """flax `nn.Dropout(rate)` in train mode: keep each element with
    probability 1 − rate, scaled by 1/(1 − rate), the mask drawn from
    `generator` on x's device."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class C3D(nn.Module):
    """C3D classifier (JAX models/c3d.py:30-98).  `width` shrinks every layer,
    `w = max(int(f·width), 8)` (width 1 is the reference topology);
    `clip_thw` is the (T, H, W) it is built for, which sizes fc6.  Dropout
    acts in train mode only.  `compute_dtype`, when set, is the dtype the
    model computes in while its weights stay in theirs (f32 master weights,
    each cast in the forward, as `I3D`).  `quant` (True or 'dynamic',
    'calib', 'static') runs the convs in int8, inference only."""

    def __init__(
        self,
        num_classes: int = 11,
        width: float = 1.0,
        dropout_rate: float = 0.5,
        clip_thw: Tuple[int, int, int] = (16, 112, 112),
        generator: Optional[torch.Generator] = None,
        quant: Union[bool, str] = False,
    ):
        super().__init__()
        w = lambda f: max(int(f * width), 8)  # noqa: E731
        c_in = 3
        for name, features, _ in _CONVS:
            setattr(self, name, _conv(c_in, w(features), generator, quant))
            c_in = w(features)
        self.quant = quant
        self.fc6 = _dense(c3d_flat_features(clip_thw, c_in), w(FC_FEATURES), generator)
        self.fc7 = _dense(w(FC_FEATURES), w(FC_FEATURES), generator)
        self.fc8 = _dense(w(FC_FEATURES), num_classes, generator)
        self.dropout_rate = dropout_rate
        self.compute_dtype: Optional[torch.dtype] = None

    @property
    def dtype(self) -> torch.dtype:
        """The working dtype: `compute_dtype`, else that of the weights."""
        return self.compute_dtype or self.conv1.weight.dtype

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits of NTHWC clips; in train mode with a dropout rate, the
        dropout masks come from `generator` (required)."""
        dt = self.dtype
        if self.quant and self.training:
            raise ValueError("quant C3D is inference-only")
        drop = self.training and self.dropout_rate > 0.0
        if drop and generator is None:
            raise ValueError("C3D's dropout in train mode draws from an explicit generator; none was given")
        dense = lambda m, x: F.linear(x.to(dt), m.weight.to(dt), m.bias.to(dt))  # noqa: E731
        x = to_ncdhw(x.to(dt))
        for name, _, pool in _CONVS:
            conv = getattr(self, name)
            if self.quant:
                x = F.relu(conv(x))
            else:
                x = F.relu(F.conv3d(x, conv.weight.to(dt), conv.bias.to(dt), padding=1))
            if pool == "pad+pool":  # ZeroPadding3D(((0,0),(0,1),(0,1))) (reference train.py:1259-1261)
                x = F.pad(x, (0, 1, 0, 1))
                pool = (2, 2, 2)
            if pool is not None:
                x = max_pool_3d(x, pool, pool, padding="VALID")
        x = F.relu(dense(self.fc6, flatten(x)))
        if drop:
            x = dropout(x, self.dropout_rate, generator)
        x = F.relu(dense(self.fc7, x))
        if drop:
            x = dropout(x, self.dropout_rate, generator)
        return dense(self.fc8, x).float()

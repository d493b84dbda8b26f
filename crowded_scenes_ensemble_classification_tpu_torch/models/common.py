"""Shared building blocks of the ported I3D.

Counterpart of `crowded_scenes_ensemble_classification_tpu/models/common.py`.
Public functions take NTHWC tensors like the JAX package; modules run on
NCDHW tensors in `torch.channels_last_3d` memory, which is the same bytes:
`x.permute(0, 4, 1, 2, 3)` of a contiguous NTHWC tensor is such a tensor.

TF-SAME padding is asymmetric on even strides (the extra pad goes right),
and torch's symmetric `padding=` would shift the windows, so every conv and
pool here pads explicitly with `same_pads`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

# JAX models/common.py:24-25 (Keras 2.2.4 defaults); torch counts momentum
# from the other side: 1 - 0.99.
KERAS_BN_EPS = 1e-3
TORCH_BN_MOMENTUM = 0.01


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """TF-SAME (before, after) padding of one axis (tests/oracle_i3d.py:36-39)."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _same_pads(x: torch.Tensor, kernel, strides):
    """TF-SAME (before, after) pads of the (D, H, W) axes of an NCDHW tensor."""
    return [same_pads(int(n), k, s) for n, k, s in zip(x.shape[2:], kernel, strides)]


def _pad(x: torch.Tensor, pads, value: float = 0.0) -> torch.Tensor:
    flat = [p for axis in reversed(pads) for p in axis]  # F.pad lists W first
    return F.pad(x, flat, value=value) if any(flat) else x


def to_ncdhw(x: torch.Tensor) -> torch.Tensor:
    """NTHWC → NCDHW view (channels_last_3d memory when x is contiguous)."""
    return x.permute(0, 4, 1, 2, 3)


def to_nthwc(x: torch.Tensor) -> torch.Tensor:
    """NCDHW → contiguous NTHWC (a view when x is channels_last_3d)."""
    return x.permute(0, 2, 3, 4, 1).contiguous()


def max_pool_3d(x: torch.Tensor, window, strides) -> torch.Tensor:
    """TF-SAME MaxPooling3D of an NCDHW tensor: −inf padding, then a VALID
    pool (JAX models/common.py:28-35)."""
    x = _pad(x, _same_pads(x, window, strides), value=float("-inf"))
    return F.max_pool3d(x, kernel_size=window, stride=strides)


def avg_pool_3d(x: torch.Tensor, window, strides=(1, 1, 1)) -> torch.Tensor:
    """VALID AveragePooling3D of an NCDHW tensor (JAX models/common.py:38-45)."""
    return F.avg_pool3d(x, kernel_size=window, stride=strides)


def flatten(x: torch.Tensor) -> torch.Tensor:
    """Keras Flatten of a channels-last tensor: an NCDHW tensor is flattened
    in (T, H, W, C) order, the order the Dense kernel expects."""
    return to_nthwc(x).reshape(x.shape[0], -1)


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]):
    """flax's lecun_normal: truncated normal at ±2σ, rescaled so the variance
    is 1/fan_in (flax variance_scaling(1.0, 'fan_in', 'truncated_normal'))."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        w.mul_(std)
    return w


def _make_bn(features: int) -> nn.BatchNorm3d:
    """BatchNorm(scale=False): the weight is a fixed 1, not a parameter of
    the reference, and is frozen."""
    bn = nn.BatchNorm3d(features, eps=KERAS_BN_EPS, momentum=TORCH_BN_MOMENTUM)
    bn.weight.requires_grad_(False)
    return bn


class ConvBN(nn.Module):
    """Conv3d (no bias, TF-SAME) + BatchNorm(scale=False) + ReLU on NCDHW
    (JAX models/common.py:48-107)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel: Tuple[int, int, int],
        strides: Tuple[int, int, int] = (1, 1, 1),
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.kernel = tuple(kernel)
        self.strides = tuple(strides)
        self.conv = nn.Conv3d(in_features, features, kernel, stride=strides, bias=False)
        lecun_normal_(self.conv.weight, in_features * math.prod(kernel), generator)
        self.bn = _make_bn(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # TF-SAME puts the odd pad after: copy-pad only that excess and let
        # the conv pad the symmetric part.
        pads = _same_pads(x, self.kernel, self.strides)
        x = _pad(x, [(0, after - before) for before, after in pads])
        x = F.conv3d(x, self.conv.weight, stride=self.strides, padding=[before for before, _ in pads])
        return F.relu(self.bn(x))


# ----------------------------------------------------------------------
# Space-to-depth stem (JAX models/common.py:450-484, 601-667)
# ----------------------------------------------------------------------


def s2d_stem_stage(x: torch.Tensor) -> torch.Tensor:
    """The input half of the s2d stem rewrite: NTHWC (N, T, H, W, C) →
    xs (N, T, H/2+3, W/2+3, 4C), channels in (dy, dx, c) order.  Computed
    once per batch and shared by every ensemble member."""
    n, t, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"s2d stem needs even spatial dims, got {h}x{w}")
    xp = F.pad(x, (0, 0, 2, 4, 2, 4))
    hp, wp = h + 6, w + 6
    xs = xp.reshape(n, t, hp // 2, 2, wp // 2, 2, c)
    return xs.permute(0, 1, 2, 4, 3, 5, 6).reshape(n, t, hp // 2, wp // 2, 4 * c)


def s2d_stem_kernel(weight: torch.Tensor) -> torch.Tensor:
    """The weight half: canonical (F, C, 7, 7, 7) → (F, 4C, 7, 4, 4) such
    that the 7³/2 TF-SAME stem conv of x equals the (2,1,1)-strided conv of
    `s2d_stem_stage(x)` with temporal pads (2, 3)."""
    f, c, kt, kh, kw = weight.shape
    if (kt, kh, kw) != (7, 7, 7):
        raise ValueError(f"s2d stem needs a 7x7x7 kernel, got {(kt, kh, kw)}")
    k = weight.permute(2, 3, 4, 1, 0)  # (kt, kh, kw, C, F) as in the reference
    k = F.pad(k, (0, 0, 0, 0, 0, 1, 0, 1))
    k = k.reshape(kt, 4, 2, 4, 2, c, f).permute(0, 1, 3, 2, 4, 5, 6)
    return k.reshape(kt, 4, 4, 4 * c, f).permute(4, 3, 0, 1, 2)


class PrestagedS2DStemConvBN(nn.Module):
    """I3D stem on a pre-staged s2d input (NTHWC `s2d_stem_stage` output).
    Holds the canonical 7³ `conv.weight`, so its state dict equals the
    canonical stem's `ConvBN` (JAX models/common.py:601-667)."""

    def __init__(self, in_features: int, features: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = nn.Conv3d(in_features, features, 7, stride=2, bias=False)
        lecun_normal_(self.conv.weight, in_features * 343, generator)
        self.bn = _make_bn(features)

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        x = F.pad(to_ncdhw(xs), (0, 0, 0, 0, 2, 3))  # temporal SAME pads (2, 3)
        w = s2d_stem_kernel(self.conv.weight).contiguous(memory_format=torch.channels_last_3d)
        x = F.conv3d(x, w, stride=(2, 1, 1))
        return F.relu(self.bn(x))


def cast_for_inference(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Hold conv and dense weights in `dtype` and in channels_last_3d
    memory; BatchNorm parameters and running stats stay float32 (the JAX
    models keep param_dtype float32 and compute in `dtype`)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv3d, nn.Linear)):
            m.to(dtype)
        if isinstance(m, nn.Conv3d):
            m.weight.data = m.weight.data.contiguous(memory_format=torch.channels_last_3d)
    return module

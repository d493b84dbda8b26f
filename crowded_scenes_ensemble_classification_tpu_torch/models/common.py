"""Shared building blocks of the ported model families.

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

from ..ops.kernels.stem_conv import s2d_stem_kernel, s2d_stem_stage, stem_conv_7x7x7_s2

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


def max_pool_3d(x: torch.Tensor, window, strides, padding: str = "SAME") -> torch.Tensor:
    """MaxPooling3D of an NCDHW tensor (JAX models/common.py:28-35): TF-SAME
    is −inf padding then a VALID pool; VALID drops the windows that do not
    fit (C3D's pools)."""
    if padding == "SAME":
        x = _pad(x, _same_pads(x, window, strides), value=float("-inf"))
    elif padding != "VALID":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
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


class KerasBatchNorm3d(nn.BatchNorm3d):
    """Keras BatchNormalization, eps 1e-3, momentum 0.99.  With scale=False
    (I3D, JAX models/common.py:96-105) the weight is a fixed 1, not a
    parameter of the reference, and is frozen; with scale=True (R3D's
    full-affine BN, JAX models/common.py:381-397) it is the trained gamma.

    Eval mode is `nn.BatchNorm3d`'s.  Train mode follows flax and Keras, not
    torch: it normalises with the biased batch statistics, computed in at
    least f32 (`aten.native_batch_norm`, which returns the batch mean and
    1/sqrt(var + eps)), and updates the running statistics with momentum
    0.99 and the BIASED variance, where torch would use the unbiased one
    and drift by n/(n−1) every step.  The state dict is nn.BatchNorm3d's."""

    def __init__(self, features: int, scale: bool = False):
        super().__init__(features, eps=KERAS_BN_EPS, momentum=TORCH_BN_MOMENTUM)
        self.weight.requires_grad_(scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y, mean, invstd = torch.ops.aten.native_batch_norm(x, self.weight, self.bias, None, None, True, 0.0,
                                                           self.eps)
        with torch.no_grad():
            keep = 1.0 - self.momentum  # flax's momentum, 0.99
            self.running_mean.mul_(keep).add_(mean, alpha=self.momentum)
            # The biased variance comes back through 1/sqrt(var + eps): for a
            # variance far below eps (a constant channel) the round trip can
            # land an ulp of eps below 0, so it is clamped there.
            var = (invstd.pow(-2) - self.eps).clamp_min_(0.0)
            self.running_var.mul_(keep).add_(var, alpha=self.momentum)
        return y


def conv3d_same(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], strides) -> torch.Tensor:
    """TF-SAME conv of an NCDHW tensor.  TF-SAME puts the odd pad after:
    copy-pad only that excess and let the conv pad the symmetric part."""
    pads = _same_pads(x, weight.shape[2:], strides)
    x = _pad(x, [(0, after - before) for before, after in pads])
    return F.conv3d(x, weight, bias, stride=strides, padding=[before for before, _ in pads])


class BNRelu(nn.Module):
    """Full-affine BatchNorm + ReLU on NCDHW, R3D's pre-activation (JAX
    models/common.py:381-397, reference `_bn_relu` train.py:1278-1281)."""

    def __init__(self, features: int):
        super().__init__()
        self.bn = KerasBatchNorm3d(features, scale=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(x))


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
        self.strides = tuple(strides)
        self.conv = nn.Conv3d(in_features, features, kernel, stride=strides, bias=False)
        lecun_normal_(self.conv.weight, in_features * math.prod(kernel), generator)
        self.bn = KerasBatchNorm3d(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.conv.weight.to(x.dtype)  # the f32 master weight of a trainable model, cast
        return F.relu(self.bn(conv3d_same(x, w, None, self.strides)))


# ----------------------------------------------------------------------
# The stem variants (JAX models/common.py:424-484, 554-692).  All hold the
# canonical 7³ `conv.weight` and `bn`, so their state dicts equal the
# canonical stem's `ConvBN` and checkpoints load into any of them.  The s2d
# staging and weight rearrangement (`s2d_stem_stage`, `s2d_stem_kernel`)
# live beside the stem kernel in ops/kernels/stem_conv.py.
# ----------------------------------------------------------------------


def _s2d_conv(xs: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The (7,4,4)/(2,1,1) conv of an NTHWC s2d staging with temporal pads
    (2, 3) → NCDHW (channels_last_3d memory)."""
    x = F.pad(to_ncdhw(xs), (0, 0, 0, 0, 2, 3))  # temporal SAME pads (2, 3)
    w = s2d_stem_kernel(weight.to(xs.dtype)).contiguous(memory_format=torch.channels_last_3d)
    return F.conv3d(x, w, stride=(2, 1, 1))


def s2d_stem_conv(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The 7³/2 TF-SAME stem conv of NTHWC clips (even T, H, W) as the
    exact s2d rewrite: NTHWC (N, T, H, W, C) × canonical (F, C, 7, 7, 7) →
    NTHWC (N, T/2, H/2, W/2, F) (JAX models/common.py:424-447)."""
    return to_nthwc(_s2d_conv(s2d_stem_stage(x), weight))


class PrestagedS2DStemConvBN(nn.Module):
    """I3D stem on a pre-staged s2d input (NTHWC `s2d_stem_stage` output).
    Holds the canonical 7³ `conv.weight`, so its state dict equals the
    canonical stem's `ConvBN` (JAX models/common.py:601-667)."""

    def __init__(self, in_features: int, features: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = nn.Conv3d(in_features, features, 7, stride=2, bias=False)
        lecun_normal_(self.conv.weight, in_features * 343, generator)
        self.bn = KerasBatchNorm3d(features)

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(_s2d_conv(xs, self.conv.weight)))


class S2DStemConvBN(ConvBN):
    """The 7³/2 stem ConvBN with its conv done as `s2d_stem_conv` on NCDHW
    clips (JAX models/common.py:670-692)."""

    def __init__(self, in_features: int, features: int, generator: Optional[torch.Generator] = None):
        super().__init__(in_features, features, (7, 7, 7), (2, 2, 2), generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = s2d_stem_conv(to_nthwc(x), self.conv.weight)
        return F.relu(self.bn(to_ncdhw(y)))


class PallasStemConvBN(ConvBN):
    """The 7³/2 stem ConvBN with its conv done by the hand-written stem
    kernel, `ops/kernels/stem_conv.stem_conv_7x7x7_s2`, on NCDHW clips (JAX
    models/common.py:554-598, where the kernel is Pallas).  Always the
    kernel, in eval and in train mode (the op's gradient is the canonical
    conv's): clips with an odd T, H or W raise through the kernel's checks
    rather than falling back to another conv; build such models with the
    canonical stem (`stem_impl='auto'`)."""

    def __init__(self, in_features: int, features: int, generator: Optional[torch.Generator] = None):
        super().__init__(in_features, features, (7, 7, 7), (2, 2, 2), generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = stem_conv_7x7x7_s2(to_nthwc(x), self.conv.weight.to(x.dtype))
        return F.relu(self.bn(to_ncdhw(y)))


def l2_param_penalty(module: nn.Module, weight: float = 1e-4) -> torch.Tensor:
    """`weight` · Σ k² over every conv and dense kernel, in f32: the Keras
    l2(1e-4) regularizer of the R3D family (JAX models/common.py:406-417)."""
    kernels = [m.weight for m in module.modules() if isinstance(m, (nn.Conv3d, nn.Linear))]
    return weight * sum(k.float().square().sum() for k in kernels)


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

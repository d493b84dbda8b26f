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
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels.int8_conv import int8_conv3d, int8_input_channels, pack_int8_weights, quantize_int8
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

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """In x's dtype, or cast to `dtype` after the BN (flax's
        BatchNorm(dtype) on an f32 quant conv output computes in f32)."""
        y = self.bn(x)
        return F.relu(y if dtype is None else y.to(dtype))


class ConvBN(nn.Module):
    """Conv3d (no bias, TF-SAME) + BatchNorm(scale=False) + ReLU on NCDHW
    (JAX models/common.py:48-107).  With `quant` (True or 'dynamic',
    'calib', 'static') the conv is a `QuantConv`, inference only: its f32
    output goes through the BatchNorm in f32 and is cast to the input's
    dtype after, as flax's BatchNorm(dtype) computes in f32 and casts last."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel: Tuple[int, int, int],
        strides: Tuple[int, int, int] = (1, 1, 1),
        generator: Optional[torch.Generator] = None,
        quant: Union[bool, str] = False,
    ):
        super().__init__()
        self.strides = tuple(strides)
        self.quant = quant
        if quant:
            self.conv = QuantConv(in_features, features, kernel, strides, bias=False, mode=quant_mode(quant),
                                  generator=generator)
        else:
            self.conv = nn.Conv3d(in_features, features, kernel, stride=strides, bias=False)
            lecun_normal_(self.conv.weight, in_features * math.prod(kernel), generator)
        self.bn = KerasBatchNorm3d(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant:
            if self.training:
                raise ValueError("quant ConvBN is inference-only")
            return F.relu(self.bn(self.conv(x)).to(x.dtype))
        w = self.conv.weight.to(x.dtype)  # the f32 master weight of a trainable model, cast
        return F.relu(self.bn(conv3d_same(x, w, None, self.strides)))


# ----------------------------------------------------------------------
# int8 quantized inference (JAX models/common.py:111-296).  Weights are
# quantized per output channel from their f32 values, activations per
# tensor: by their own max|x| (dynamic) or by a calibrated scale
# (static).  The contraction is int8 × int8 → int32 in the hand-written
# kernel `ops/kernels/int8_conv.int8_conv3d`, dequantized to f32 in its
# epilogue; the quantize pass is `quantize_int8`.  Public functions take
# NTHWC activations and the port's OIDHW (F, C, kd, kh, kw) kernels.
# ----------------------------------------------------------------------

QUANT_MODES = ("dynamic", "calib", "static")
Padding = Union[str, Sequence[Tuple[int, int]]]


def quant_mode(quant) -> str:
    """The zoo-wide `quant` attribute (True or a mode) as a QuantConv mode:
    True means 'dynamic' (JAX models/common.py:159-162)."""
    return quant if isinstance(quant, str) else "dynamic"


def conv_pads(shape: Sequence[int], kernel: Sequence[int], strides: Sequence[int], padding: Padding):
    """(before, after) pads of the (D, H, W) axes: 'SAME' (TF-SAME),
    'VALID', or explicit pairs."""
    if padding == "SAME":
        return [same_pads(int(n), k, s) for n, k, s in zip(shape, kernel, strides)]
    if padding == "VALID":
        return [(0, 0)] * 3
    return [tuple(p) for p in padding]


def weight_qparams(kernel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 quantization of an OIDHW kernel
    (JAX models/common.py:165-173): sw = max(max|W[f]|, 1e-30)/127 and
    k8 = round(W/sw), both from the f32 values; kernel ≈ k8·sw."""
    kf = kernel.float()
    sw = kf.abs().amax(dim=tuple(range(1, kf.dim()))).clamp_min(1e-30) / 127.0
    return torch.round(kf / sw.view(-1, *[1] * (kf.dim() - 1))).to(torch.int8), sw


def _quantize(x: torch.Tensor, scalar: torch.Tensor, dynamic: bool) -> torch.Tensor:
    """NTHWC x → the int8 conv's x8, its pixels widened with zeros to
    `int8_input_channels` (16 for the s2d stems' 4C = 12 and 8)."""
    return quantize_int8(x.contiguous(), scalar, dynamic, int8_input_channels(x.shape[-1]))


def quant_conv_general(x: torch.Tensor, kernel: torch.Tensor, strides, padding: Padding,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dynamic int8 conv (JAX models/common.py:111-156): NTHWC x × OIDHW
    kernel → f32 NTHWC.  sx = max(max|x|, 1e-30)/127 over the whole tensor,
    x8 = round(x/sx) (a division), per-channel weight scales, int32
    accumulation, dequantized by sx·sw; `bias` added after, in f32."""
    k8, sw = weight_qparams(kernel)
    sx = x.abs().amax().float().clamp_min(1e-30) / 127.0
    pads = conv_pads(x.shape[1:4], k8.shape[2:], strides, padding)
    return int8_conv3d(_quantize(x, sx, True), pack_int8_weights(k8), sx * sw, bias, k8.shape[2:], strides, pads)


def static_operands(k8: torch.Tensor, sw: torch.Tensor, act_scale: torch.Tensor) -> tuple:
    """What a static conv needs besides x: k8 packed for the kernel
    (`pack_int8_weights`), inv = 1/max(act_scale, 1e-30) and the
    dequantize scale act_scale·sw, as JAX computes them."""
    return pack_int8_weights(k8), 1.0 / act_scale.float().clamp_min(1e-30), act_scale * sw


def _static_conv(x: torch.Tensor, operands: tuple, bias: Optional[torch.Tensor], kernel, strides,
                 padding: Padding) -> torch.Tensor:
    wp, inv, scale = operands
    pads = conv_pads(x.shape[1:4], kernel, strides, padding)
    return int8_conv3d(_quantize(x, inv, False), wp, scale, bias, kernel, strides, pads)


def static_quant_conv_general(x: torch.Tensor, k8: torch.Tensor, sw: torch.Tensor, act_scale: torch.Tensor,
                              strides, padding: Padding, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Static int8 conv (JAX models/common.py:176-208): NTHWC x, an OIDHW
    int8 k8 with its scales sw, a calibrated per-tensor act_scale (a 0-dim
    f32 tensor) → f32 NTHWC.  inv = 1/max(act_scale, 1e-30), x8 =
    round(clip(x·inv, −127, 127)) (a multiply: out-of-range activations
    saturate), dequantized by act_scale·sw; `bias` added after."""
    return _static_conv(x, static_operands(k8, sw, act_scale), bias, k8.shape[2:], strides, padding)


def _tensor_key(t: torch.Tensor) -> tuple:
    """What identifies a tensor's current values for a cache: its storage,
    device and, unless it is an inference tensor (which keeps no version
    counter and cannot be written outside inference mode), its version."""
    return t.data_ptr(), t.device, None if t.is_inference() else t._version


def _traced(*tensors: torch.Tensor) -> bool:
    """Whether this call is being traced (`torch.compile`, `torch.export`):
    the tensors are then fake or functional stand-ins with no storage."""
    return torch.compiler.is_compiling() or any(type(t) not in (torch.Tensor, nn.Parameter) for t in tensors)


_STATIC_OPERANDS = ("static_wp", "static_inv", "static_scale")


def _refresh_after_load(module: nn.Module, incompatible_keys) -> None:
    module.refresh_static_operands()


class _QuantBuffers:
    """The optional quant state of a quantized site: `act_absmax` (the
    running max|x| of 'calib', read by 'static'; JAX's qstats) and, on a
    QuantConv, the baked `k8`/`sw` (JAX's qparams).  A state dict without
    them (a plain checkpoint) loads, its stats starting at 0 as JAX's do;
    baked ones are taken when present."""

    def _register_quant_buffers(self, mode: str) -> None:
        if mode not in QUANT_MODES:
            raise ValueError(f"unknown quant mode {mode!r}")
        self.quant_mode = mode
        if mode != "dynamic":
            self.register_buffer("act_absmax", torch.zeros((), dtype=torch.float32))

    def _baked_shapes(self) -> dict:
        return {}

    # The static operands (`static_operands`: packed k8, inv, dequantize
    # scale) are held as non-persistent buffers, computed when a site turns
    # static, is baked or loaded (`refresh_static_operands`), so the state
    # dict is unchanged, `.to()` moves them, and a traced forward reads them
    # as constants: a static site is a pure function of its variables, as
    # JAX's is.  Eager calls recompute them first when a source changed.

    def _register_static_operands(self) -> None:
        for name in _STATIC_OPERANDS:
            self.register_buffer(name, None, persistent=False)
        self._static_key: Optional[tuple] = None  # `_tensor_key`s of the sources they were computed from
        self.register_load_state_dict_post_hook(_refresh_after_load)

    def _static_sources(self) -> Optional[tuple]:
        """The tensors the static operands are computed from, or None where
        the site holds none (not static, or a QuantConv not baked)."""
        raise NotImplementedError

    def _compute_static_operands(self) -> tuple:
        raise NotImplementedError

    def refresh_static_operands(self) -> None:
        """Recompute the held static operands if a source changed since they
        were computed (or drop them where the site holds none).  Never
        called while tracing: it reads storage pointers."""
        sources = self._static_sources()
        if sources is None or any(t.is_meta for t in sources):
            self._static_key = None
            for name in _STATIC_OPERANDS:
                setattr(self, name, None)
            return
        key = tuple(_tensor_key(t) for t in sources)
        if self.static_wp is None or key != self._static_key:
            with torch.inference_mode(False), torch.no_grad():  # plain tensors, which an export can carry
                for name, t in zip(_STATIC_OPERANDS, self._compute_static_operands()):
                    setattr(self, name, t)
            self._static_key = key

    def held_static_operands(self) -> tuple:
        """The static operands: refreshed and held in eager calls; while
        tracing, the held buffers (where none are held, as on the meta
        device, the same computation in the call or the graph)."""
        if not _traced(*self._static_sources()):
            self.refresh_static_operands()
        if self.static_wp is None:
            return self._compute_static_operands()
        return tuple(getattr(self, name) for name in _STATIC_OPERANDS)

    def _load_from_state_dict(self, state_dict, prefix, local_metadata, strict, missing_keys, unexpected_keys,
                              error_msgs):
        mode = getattr(self, "quant_mode", None)
        if mode is None:  # an unquantized stem
            return super()._load_from_state_dict(state_dict, prefix, local_metadata, strict, missing_keys,
                                                 unexpected_keys, error_msgs)
        dynamic = mode == "dynamic"
        for name, (shape, dtype) in self._baked_shapes().items():
            if not dynamic and prefix + name in state_dict and getattr(self, name) is None:
                setattr(self, name, torch.empty(shape, dtype=dtype, device=self.act_absmax.device))
        n_missing, n_unexpected = len(missing_keys), len(unexpected_keys)
        super()._load_from_state_dict(state_dict, prefix, local_metadata, strict, missing_keys, unexpected_keys,
                                      error_msgs)
        quant_keys = {prefix + k for k in ("act_absmax", *self._baked_shapes())}
        missing_keys[n_missing:] = [k for k in missing_keys[n_missing:] if k != prefix + "act_absmax"]
        if dynamic:  # a dynamic site has no use for a calibrated state
            unexpected_keys[n_unexpected:] = [k for k in unexpected_keys[n_unexpected:] if k not in quant_keys]

    def record_absmax(self, x: torch.Tensor) -> None:
        """'calib': act_absmax ← max(act_absmax, max|x|)."""
        with torch.no_grad():
            self.act_absmax.copy_(torch.maximum(self.act_absmax, x.abs().amax().float()))


class QuantConv(_QuantBuffers, nn.Conv3d):
    """int8 inference stand-in for a conv with TF-SAME, VALID or explicit
    padding (JAX models/common.py:211-275).  Its parameters are
    nn.Conv3d's (`weight` OIDHW f32, optional `bias`), so plain checkpoints
    load unchanged; only the contraction changes with `quant_mode`:

    - 'dynamic': `quant_conv_general`, a per-call activation scale;
    - 'calib': the EXACT f32 conv, recording the running max|x| in
      `act_absmax` (TF32 off: `models.quantize.calibrate` turns it off);
    - 'static': `static_quant_conv_general` with act_absmax/127, and the
      baked `k8`/`sw` (`models.quantize.quantize_variables`) when present,
      else the weights quantized in the forward.  With k8/sw baked, the
      packed weights and the two scales (`static_operands`) are held as
      non-persistent buffers, recomputed when k8, sw or act_absmax change.

    Takes NCDHW x of any float dtype, returns f32 NCDHW (channels_last_3d
    memory); the bias is added in f32 after the dequantize."""

    def __init__(self, in_features: int, features: int, kernel, strides=(1, 1, 1), padding: Padding = "SAME",
                 bias: bool = True, mode: str = "dynamic", generator: Optional[torch.Generator] = None):
        super().__init__(in_features, features, kernel, stride=strides, bias=bias)
        lecun_normal_(self.weight, in_features * math.prod(self.kernel_size), generator)
        if bias:
            nn.init.zeros_(self.bias)
        self.tf_padding = padding
        self._register_quant_buffers(mode)
        self.register_buffer("k8", None)
        self.register_buffer("sw", None)
        self._register_static_operands()

    def _baked_shapes(self) -> dict:
        return {"k8": (tuple(self.weight.shape), torch.int8), "sw": ((self.out_channels,), torch.float32)}

    def _static_sources(self) -> Optional[tuple]:
        if self.quant_mode != "static" or self.k8 is None:
            return None
        return self.k8, self.sw, self.act_absmax

    def _compute_static_operands(self) -> tuple:
        return static_operands(self.k8, self.sw, self.act_absmax / 127.0)

    def static_operands(self) -> tuple:
        """`static_operands` of 'static': from the baked k8/sw, held between
        calls (JAX bakes them once), else from the weights quantized now
        (JAX's in-graph quantization)."""
        if self.k8 is None:
            return static_operands(*weight_qparams(self.weight), self.act_absmax / 127.0)
        return self.held_static_operands()

    def forward(self, x: torch.Tensor, strides: Optional[Sequence[int]] = None) -> torch.Tensor:
        """`strides` overrides the module's (R3D's shortcut takes its strides
        from the two shapes it joins)."""
        strides = tuple(strides or self.stride)
        bias = None if self.bias is None else self.bias.float()
        if self.quant_mode == "calib":
            self.record_absmax(x)
            pads = conv_pads(x.shape[2:], self.kernel_size, strides, self.tf_padding)
            y = F.conv3d(_pad(x.float(), pads), self.weight.float(), None, stride=strides)
            return y if bias is None else y + bias.view(-1, 1, 1, 1)
        xt = to_nthwc(x)
        if self.quant_mode == "dynamic":
            y = quant_conv_general(xt, self.weight, strides, self.tf_padding, bias)
        else:
            y = _static_conv(xt, self.static_operands(), bias, self.kernel_size, strides, self.tf_padding)
        return to_ncdhw(y)


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


_S2D_KERNEL, _S2D_STRIDES, _S2D_PADS = (7, 4, 4), (2, 1, 1), ((2, 3), (0, 0), (0, 0))  # the s2d form's conv


class PrestagedS2DStemConvBN(_QuantBuffers, nn.Module):
    """I3D stem on a pre-staged s2d input (NTHWC `s2d_stem_stage` output).
    Holds the canonical 7³ `conv.weight`, so its state dict equals the
    canonical stem's `ConvBN` (JAX models/common.py:601-667).

    With `quant`, inference only, the conv runs on the DERIVED s2d kernel
    `s2d_stem_kernel(W)` of the f32 weight: 'dynamic' quantizes it and the
    input per call; 'calib' runs the exact f32 prestaged conv and records
    max|xs| in this module's `act_absmax`; 'static' quantizes the derived
    kernel against act_absmax/127: the values JAX computes in its forward,
    held as non-persistent buffers and recomputed when the weight or
    act_absmax change.  The derived kernel is never baked into the state
    dict, as in JAX.  BatchNorm runs on the f32 output and the result is
    cast to xs's dtype after."""

    def __init__(self, in_features: int, features: int, generator: Optional[torch.Generator] = None,
                 quant: Union[bool, str] = False):
        super().__init__()
        self.conv = nn.Conv3d(in_features, features, 7, stride=2, bias=False)
        lecun_normal_(self.conv.weight, in_features * 343, generator)
        self.bn = KerasBatchNorm3d(features)
        self.quant = quant
        if quant:
            self._register_quant_buffers(quant_mode(quant))
            self._register_static_operands()

    def _static_sources(self) -> Optional[tuple]:
        return (self.conv.weight, self.act_absmax) if self.quant_mode == "static" else None

    def _compute_static_operands(self) -> tuple:
        """`static_operands` of the derived s2d kernel."""
        k8, sw = weight_qparams(s2d_stem_kernel(self.conv.weight.float()))
        return static_operands(k8, sw, self.act_absmax / 127.0)

    def _quant_conv(self, xs: torch.Tensor) -> torch.Tensor:
        """The s2d conv of NTHWC xs under `quant_mode` → f32 NCDHW."""
        w = self.conv.weight
        if self.quant_mode == "dynamic":
            y = quant_conv_general(xs, s2d_stem_kernel(w.float()), _S2D_STRIDES, _S2D_PADS)
        elif self.quant_mode == "calib":
            self.record_absmax(xs)
            return _s2d_conv(xs.float(), w.float())
        else:
            y = _static_conv(xs, self.held_static_operands(), None, _S2D_KERNEL, _S2D_STRIDES, _S2D_PADS)
        return to_ncdhw(y)

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        if not self.quant:
            return F.relu(self.bn(_s2d_conv(xs, self.conv.weight)))
        if self.training:
            raise ValueError("quant stem is inference-only")
        return F.relu(self.bn(self._quant_conv(xs)).to(xs.dtype))


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
    models keep param_dtype float32 and compute in `dtype`).  The convs of
    quantized sites keep f32 weights: JAX quantizes them from f32."""
    quantized = {id(c) for m in module.modules() if getattr(m, "quant_mode", None)
                 for c in m.modules() if isinstance(c, nn.Conv3d)}
    for m in module.modules():
        if isinstance(m, (nn.Conv3d, nn.Linear)) and id(m) not in quantized:
            m.to(dtype)
        if isinstance(m, nn.Conv3d):
            m.weight.data = m.weight.data.contiguous(memory_format=torch.channels_last_3d)
    return module

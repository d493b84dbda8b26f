"""int8 inference: the implicit-GEMM int8 3D conv and the fused quantize pass,
the CUDA kernels and their plain versions.

No Pallas kernel computes either: the JAX package leaves its int8
contraction and its quantize pass to XLA (`models/common.py`
`quant_conv_general`, line 111, and `static_quant_conv_general`, line 176),
and PyTorch has no int8 conv3d on CUDA.  The kernels are
`csrc/int8_conv3d.cu` and `csrc/quantize_int8.cu`, behind the custom ops
`csec::int8_conv3d` and `csec::quantize_int8`.  Neither has a gradient:
quantized inference is inference only.

- `quantize_int8(x, scalar, dynamic, channels)`: bf16/f32 → int8 of the
  same shape, `round(clip(x·inv, −127, 127))` (static, `scalar` = inv) or
  `round(x/sx)` (dynamic, `scalar` = sx), half to even, each innermost row
  zero-padded to `channels` (`int8_input_channels`, the conv's pixel).
  `scalar` is a one-element f32 tensor on x's device, so the host never
  reads it.
- `int8_conv3d(x8, wp, scale, bias, kernel, strides, pads)`: int8 NTHWC ×
  packed int8 weights (`pack_int8_weights`) → f32 NTHWC,
  `float(acc)·scale[f]` then `+ bias[f]`, two roundings as in JAX.
  Strides and (before, after) zero pads are per axis.  The kernel takes
  one of two routes (`int8_conv_route`): tiles of 128 positions × F with
  A gathered chunk by chunk, or, for 16-channel convs with no spatial
  pads (the I3D stems on their staging), whole input rows in shared
  memory.

The plain conv is exact: `F.conv3d` in float64 on the int8 values (|Σ| ≤
K·127² < 2^53 for any K here; float32 stops being exact once K·127² passes
2^24, at K > 1,040), rounded to int32, then the same f32 dequantize.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ._build import check_launch, count_launch, load_library

K_STEP = 128  # the kernel's K stage, one 128-byte swizzle atom: packed rows are padded to a multiple
F_TILE = 16  # packed F is padded to a multiple (the kernel zero-fills weight rows past it)
M_TILE = 128  # the kernel's rows of output positions a block
F_TILES = (64, 128, 192, 256)  # the kernel's F tiles (wgmma N), one instance each
H100_SMS = 132

Pads = Sequence[Tuple[int, int]]


def padded_channels(c: int) -> int:
    """Cp, the channels of one tap in the packed weights: C where C is a
    multiple of 16 or below 8, else C rounded up to 16, so that the
    kernel's 16-byte chunks of K never straddle two taps (4C = 12 → 16,
    Cin = 24 → 32)."""
    return c if c % 16 == 0 or c < 8 else -(-c // 16) * 16


def int8_input_channels(c: int) -> int:
    """The channels of a pixel of the int8 conv's input, as the quantize
    pass writes it, for a conv on C channels: 16 from 8 to 15 (the s2d
    stems' 4C = 12 and 8), so that the kernel copies whole 16-byte pixels
    and the I3D stems fit its row slab; else C (below 8 the kernel reads
    byte by byte, and above 16 the tap padding stays in the packed
    weights).  The added channels are zeros, against the packed weights'
    zero channels, so every sum is the same."""
    return padded_channels(c) if c < 16 else c


def int8_conv_tiling(m: int, f: int, kpad: int, sms: int = H100_SMS) -> Tuple[int, int]:
    """(F tile, K splits) of the kernel for M output positions, F channels
    and packed depth kpad.  The F tile keeps the padded products and the
    re-reads of A (one per F tile, priced at 64 columns) least.  K is split
    when that fills more of the card's `sms` (one block an SM), in units of
    one K stage's time: s splits cost the waves they take times the stages
    a block walks plus 5 for its prologue and epilogue, plus 10 for the
    finish kernel that adds the splits; a split walks ceil(steps / s)
    stages, and none is left empty."""
    bn = min(F_TILES, key=lambda b: (-(-f // b) * (b + 64), -b))
    blocks, steps = -(-m // M_TILE) * -(-f // bn), kpad // K_STEP
    cost = lambda s: -(-blocks * s // sms) * (-(-steps // s) + 5) + 10 * (s > 1)  # noqa: E731
    per = -(-steps // min(range(1, min(8, steps) + 1), key=cost))  # stages a split walks
    return bn, -(-steps // per)  # no split left empty


def pack_int8_weights(k8: torch.Tensor) -> torch.Tensor:
    """int8 OIDHW (F, C, kd, kh, kw) → the kernel's (Fpad, Kpad) int8,
    contiguous: row f holds K = kd·kh·kw·Cp in (tap, channel) order, each
    tap's channels zero-padded from C to Cp (`padded_channels`), then
    zeros to Kpad (a multiple of K_STEP); rows past F are zero, to a
    multiple of F_TILE."""
    f, c = k8.shape[:2]
    taps = k8.permute(0, 2, 3, 4, 1).reshape(f, -1, c)
    rows = F.pad(taps, (0, padded_channels(c) - c)).reshape(f, -1)
    k = rows.shape[1]
    return F.pad(rows, (0, -k % K_STEP, 0, -f % F_TILE)).contiguous()


def unpack_int8_weights(wp: torch.Tensor, features: int, kernel: Sequence[int], channels: int) -> torch.Tensor:
    """The inverse of `pack_int8_weights`: int8 OIDHW (F, C, kd, kh, kw)."""
    kd, kh, kw = kernel
    cp = padded_channels(channels)
    taps = wp[:features, :kd * kh * kw * cp].reshape(features, kd, kh, kw, cp)
    return taps[..., :channels].permute(0, 4, 1, 2, 3)


def conv_output_shape(shape: Sequence[int], kernel: Sequence[int], strides: Sequence[int], pads: Pads) -> List[int]:
    """(Do, Ho, Wo) of (D, H, W) under the kernel, strides and pads."""
    return [(n + b + a - k) // s + 1 for n, k, s, (b, a) in zip(shape, kernel, strides, pads)]


def int8_conv3d_reference(
    x8: torch.Tensor,
    k8: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor],
    strides: Sequence[int],
    pads: Pads,
) -> torch.Tensor:
    """Plain version: int8 NTHWC x8 × int8 OIDHW k8 → f32 NTHWC
    `float(acc)·scale (+ bias)`, acc the exact integer convolution (float64,
    never TF32)."""
    flat = [p for axis in reversed(pads) for p in axis]  # F.pad lists W first
    x = F.pad(x8.permute(0, 4, 1, 2, 3).double(), flat)
    acc = torch.round(F.conv3d(x, k8.double(), stride=tuple(strides))).to(torch.int32)
    y = acc.float() * scale.view(-1, 1, 1, 1)
    if bias is not None:
        y = y + bias.view(-1, 1, 1, 1)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def quantize_int8_reference(x: torch.Tensor, scalar: torch.Tensor, dynamic: bool,
                            channels: Optional[int] = None) -> torch.Tensor:
    """Plain version of the quantize pass (JAX models/common.py:154-155,
    :196-199): dynamic `round(x / sx)`, static `round(clip(x·inv, −127,
    127))`, in f32, half to even; then zeros past the last axis to
    `channels`."""
    xf = x.float()
    q = torch.round(xf / scalar if dynamic else torch.clamp(xf * scalar, -127.0, 127.0)).to(torch.int8)
    return q if channels is None else F.pad(q, (0, channels - x.shape[-1]))


def _pairs(pad: Sequence[int]) -> List[Tuple[int, int]]:
    return [(pad[2 * i], pad[2 * i + 1]) for i in range(3)]


# ---------------------------------------------------------------------------
# csec::int8_conv3d
# ---------------------------------------------------------------------------


@torch.library.custom_op("csec::int8_conv3d", mutates_args=(), device_types="cpu")
def _int8_conv_op(
    x8: torch.Tensor,
    wp: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor],
    kernel: List[int],
    stride: List[int],
    pad: List[int],
) -> torch.Tensor:
    k8 = unpack_int8_weights(wp, scale.shape[0], kernel, x8.shape[-1])
    return int8_conv3d_reference(x8, k8, scale, bias, stride, _pairs(pad))


SLAB_STAGES = 4  # the row slab's ring slots (csrc/int8_conv3d_slab.cu, SLAB_STAGES and slab_geom)
SLAB_SMEM_LIMIT = 113 * 1024  # two blocks an SM


def _fits_row_slab(c: int, vec: int, kpad: int, kernel, strides, pads, wo: int) -> bool:
    """Whether a conv takes the kernel's row-slab route
    (csrc/int8_conv3d_slab.cu): 16 channels at 16-byte alignment, unit
    spatial strides and no spatial pads, taps in pairs along W and whole
    128-byte stages a temporal tap, rows of at most two 64-row tiles, and
    a ring that leaves room for two blocks an SM.  The I3D stems on their
    staging (16-channel pixels, `int8_input_channels`) fit.  The route is
    chosen here only: the C entry checks the layout it needs and launches
    with the shared memory its geometry takes."""
    kd, kh, kw = kernel
    slot = -(-(16 * kh * kw * 64 + (kh + 1) * -(-(2 * 64 + kw - 1) * 16 // 128) * 128) // 1024) * 1024
    return (c == 16 and vec == 16 and tuple(strides[1:]) == (1, 1) and not any(pads[1]) and not any(pads[2])
            and kw % 2 == 0 and kh * kw % 8 == 0 and wo <= 128 and kpad == kd * kh * kw * 16
            and SLAB_STAGES * slot + SLAB_STAGES * 8 + 1024 <= SLAB_SMEM_LIMIT)


def int8_conv_route(x8: torch.Tensor, wp: torch.Tensor, f: int, kernel, strides, pads, sms: int = H100_SMS) -> dict:
    """How the kernel runs the conv of int8 NTHWC x8 (its shape and
    address) with packed weights wp of depth Kpad to F channels: the
    row-slab route where it fits (`_fits_row_slab`), else the tiled one with
    its tile (`int8_conv_tiling`) and K splits; and how A reaches shared
    memory (whole input rows by bulk copy; or 16-byte chunks by 16-, 8- or
    4-byte cp.async, `vec`, 1 through registers, C < 8 byte by byte at each
    byte's own tap)."""
    c = x8.shape[-1]
    out = conv_output_shape(x8.shape[1:4], kernel, strides, pads)
    m, kpad = x8.shape[0] * math.prod(out), wp.shape[1]
    vec = _alignment_vec(c, x8.data_ptr())
    if _fits_row_slab(c, vec, kpad, kernel, strides, pads, out[2]):
        return {"tile": "2 rows x 128 x 64 (row slab)", "bn": 64, "splits": 1, "vec": vec, "slab": 1,
                "a_copy": "bulk copy of whole input rows"}
    bn, splits = int8_conv_tiling(m, f, kpad, sms)
    copy = "byte gather (C < 8)" if padded_channels(c) % 16 else (
        "register gather" if vec == 1 else f"cp.async {vec} B")
    return {"tile": f"{M_TILE}x{bn}", "bn": bn, "splits": splits, "vec": vec, "slab": 0, "a_copy": copy}


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _alignment_vec(c: int, ptr: int) -> int:
    """The widest load (16, 8, 4 or 1 bytes) that divides C and x's address."""
    return next(v for v in (16, 8, 4, 1) if c % v == 0 and ptr % v == 0)


@_int8_conv_op.register_kernel("cuda")
def _int8_conv_cuda(
    x8: torch.Tensor,
    wp: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor],
    kernel: List[int],
    stride: List[int],
    pad: List[int],
) -> torch.Tensor:
    if x8.dtype != torch.int8 or wp.dtype != torch.int8 or x8.dim() != 5 or wp.dim() != 2:
        raise TypeError("int8_conv3d: x8 must be 5-D int8 NTHWC and wp 2-D int8 (pack_int8_weights)")
    if not (x8.is_contiguous() and wp.is_contiguous()):
        raise ValueError("int8_conv3d: x8 and wp must be contiguous")
    features = scale.shape[0]
    n, d, h, w, c = x8.shape
    k = math.prod(kernel) * padded_channels(c)
    if wp.shape[0] % F_TILE or wp.shape[0] < features or wp.shape[1] % K_STEP or wp.shape[1] < k:
        raise ValueError(f"int8_conv3d: wp {tuple(wp.shape)} is not packed for F={features}, K={k}")
    for t, what in ((scale, "scale"), (bias, "bias")):
        if t is not None and (t.dtype != torch.float32 or t.shape != (features,) or not t.is_contiguous()):
            raise TypeError(f"int8_conv3d: {what} must be contiguous f32 of shape ({features},)")
    tensors = [x8, wp, scale] + ([bias] if bias is not None else [])
    if any(t.device != x8.device for t in tensors):
        raise ValueError("int8_conv3d: every tensor must be on x8's device")
    pads = _pairs(pad)
    out = conv_output_shape((d, h, w), kernel, stride, pads)
    if min(out) <= 0 or min(stride) <= 0 or min(pad) < 0:
        raise ValueError(f"int8_conv3d: no output for input {tuple(x8.shape)}, kernel {kernel}, "
                         f"strides {stride}, pads {pads}")
    y = torch.empty((n, *out, features), dtype=torch.float32, device=x8.device)
    route = int8_conv_route(x8, wp, features, kernel, stride, pads, _sm_count(x8.device))
    splits = route["splits"]
    acc = torch.empty((splits, *y.shape), dtype=torch.int32, device=x8.device) if splits > 1 else None
    with torch.cuda.device(x8.device):
        stream = torch.cuda.current_stream(x8.device).cuda_stream
        err = load_library().int8_conv3d(
            x8.data_ptr(), wp.data_ptr(), scale.data_ptr(), bias.data_ptr() if bias is not None else None,
            y.data_ptr(), acc.data_ptr() if acc is not None else None, n, d, h, w, c, *out, features,
            *wp.shape, *kernel, *stride, *(b for b, _ in pads), padded_channels(c), route["vec"], route["bn"],
            route["splits"], route["slab"], stream,
        )
    check_launch("int8_conv3d", err)
    count_launch(int8_conv3d)
    return y


@_int8_conv_op.register_fake
def _int8_conv_fake(x8, wp, scale, bias, kernel, stride, pad):
    out = conv_output_shape(x8.shape[1:4], kernel, stride, _pairs(pad))
    return torch.empty((x8.shape[0], *out, scale.shape[0]), dtype=torch.float32, device=x8.device)


def int8_conv3d(
    x8: torch.Tensor,
    wp: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor],
    kernel: Sequence[int],
    strides: Sequence[int],
    pads: Pads,
) -> torch.Tensor:
    """int8 NTHWC (N, D, H, W, C) × `pack_int8_weights(k8)` of an OIDHW
    (F, C, *kernel) k8 → f32 NTHWC (N, Do, Ho, Wo, F), `float(acc)·scale[f]`
    then `+ bias[f]` when a bias is given; strides and (before, after) zero
    pads per axis.  CUDA tensors run the kernel; CPU tensors the plain
    version.  `.launches` counts kernel launches."""
    if x8.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_conv3d: unsupported device {x8.device}")
    pad = [p for axis in pads for p in axis]
    return _int8_conv_op(x8, wp, scale, bias, list(kernel), list(strides), [int(p) for p in pad])


int8_conv3d.launches = 0


# ---------------------------------------------------------------------------
# csec::quantize_int8
# ---------------------------------------------------------------------------


@torch.library.custom_op("csec::quantize_int8", mutates_args=(), device_types="cpu")
def _quantize_op(x: torch.Tensor, scalar: torch.Tensor, dynamic: bool, channels: Optional[int]) -> torch.Tensor:
    return quantize_int8_reference(x, scalar, dynamic, channels)


@_quantize_op.register_kernel("cuda")
def _quantize_cuda(x: torch.Tensor, scalar: torch.Tensor, dynamic: bool, channels: Optional[int]) -> torch.Tensor:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quantize_int8: expected bf16 or f32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("quantize_int8: input must be contiguous")
    if scalar.dtype != torch.float32 or scalar.numel() != 1 or scalar.device != x.device:
        raise TypeError("quantize_int8: scalar must be one f32 on x's device")
    c = x.shape[-1] if x.dim() else 1
    cp = c if channels is None else channels
    if cp != c and cp % 4:
        raise ValueError(f"quantize_int8: the kernel pads rows to a multiple of 4 channels, not {cp}")
    y = _quantize_fake(x, scalar, dynamic, channels)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = load_library().quantize_int8(x.data_ptr(), y.data_ptr(), scalar.data_ptr(), x.numel() // c if c else 0,
                                           c, cp, int(x.dtype == torch.bfloat16), int(dynamic), stream)
    check_launch("quantize_int8", err)
    count_launch(quantize_int8)
    return y


@_quantize_op.register_fake
def _quantize_fake(x, scalar, dynamic, channels):
    shape = x.shape if channels is None else (*x.shape[:-1], channels)
    return torch.empty(shape, dtype=torch.int8, device=x.device)


def quantize_int8(x: torch.Tensor, scalar: torch.Tensor, dynamic: bool = False,
                  channels: Optional[int] = None) -> torch.Tensor:
    """bf16 or f32 x → int8: `round(clip(x·scalar, −127, 127))` (static:
    scalar = 1/max(act_scale, 1e-30)) or `round(x / scalar)` (dynamic:
    scalar = max(max|x|, 1e-30)/127), half to even, of x's shape, or with
    the last axis zero-padded to `channels` (`int8_input_channels`).
    `scalar` is a one-element f32 tensor on x's device.  CUDA tensors run
    the kernel; CPU tensors the plain version.  `.launches` counts kernel
    launches."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"quantize_int8: unsupported device {x.device}")
    if channels is not None and (x.dim() == 0 or channels < x.shape[-1]):
        raise ValueError(f"quantize_int8: cannot pad the last axis of {tuple(x.shape)} to {channels} channels")
    return _quantize_op(x, scalar.reshape(()), dynamic, None if channels is None else int(channels))


quantize_int8.launches = 0

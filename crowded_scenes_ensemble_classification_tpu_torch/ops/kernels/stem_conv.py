"""The I3D stem, a 7³ stride-2 TF-SAME conv: the CUDA kernel and its plain version.

Counterpart of the two Pallas TPU kernels that compute this function:
`crowded_scenes_ensemble_classification_tpu/ops/pallas/stem_conv_v8.py`
(`stem_conv_7x7x7_s2_v8`, line 140) and `.../ops/pallas/stem_conv.py`
(`stem_conv_7x7x7_s2`, line 81).  The kernel is `csrc/stem_conv7x7x7s2.cu`,
behind the custom op `csec::stem_conv_7x7x7_s2`.  Its gradient (registered
with `register_autograd`) is that of the canonical TF-SAME conv,
`aten.convolution_backward` on the padded input: the JAX package too
computes this gradient on XLA, outside any Pallas kernel.

The kernel reads the spatial space-to-depth staging of the clips and the
weights rearranged to match.  `s2d_stem_stage` and `s2d_stem_kernel` give
them as the s2d rewrite defines them (`models/common.py` uses both for the
prestaged stem, and the f32 kernel reads them); the bf16 kernel reads
`s2d_stem_stage_even` (the staged width padded to even, so every row is a
whole number of 16-byte copies) and `pack_stem_weights` (per 32-channel
part, the image of its shared memory).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import check_launch, count_launch, load_library

MAX_CHANNELS = 4  # input channels of the f32 kernel (4C = 16 s2d channels)
BF16_MAX_CHANNELS = 3  # the bf16 kernel's weights and two slabs fit 227 KB up to 4C = 12
PART = 32  # output channels of one bf16 block (an F-part)
WEIGHT_ROW_PAD = 8  # bf16 after each packed weight row: the kernel's bank spread


def s2d_stem_stage(x: torch.Tensor) -> torch.Tensor:
    """The input half of the s2d stem rewrite (JAX models/common.py:450-462):
    NTHWC (N, T, H, W, C) → xs (N, T, H/2+3, W/2+3, 4C), channels in
    (dy, dx, c) order.  Computed once per batch and shared by every
    ensemble member on the main path."""
    n, t, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"s2d stem needs even spatial dims, got {h}x{w}")
    xp = F.pad(x, (0, 0, 2, 4, 2, 4))
    hp, wp = h + 6, w + 6
    xs = xp.reshape(n, t, hp // 2, 2, wp // 2, 2, c)
    return xs.permute(0, 1, 2, 4, 3, 5, 6).reshape(n, t, hp // 2, wp // 2, 4 * c)


def s2d_stem_kernel(weight: torch.Tensor) -> torch.Tensor:
    """The weight half (JAX models/common.py:465-473): canonical
    (F, C, 7, 7, 7) → (F, 4C, 7, 4, 4) such that the 7³/2 TF-SAME stem conv
    of x equals the (2,1,1)-strided conv of `s2d_stem_stage(x)` with
    temporal pads (2, 3)."""
    f, c, kt, kh, kw = weight.shape
    if (kt, kh, kw) != (7, 7, 7):
        raise ValueError(f"s2d stem needs a 7x7x7 kernel, got {(kt, kh, kw)}")
    k = weight.permute(2, 3, 4, 1, 0)  # (kt, kh, kw, C, F) as in the reference
    k = F.pad(k, (0, 0, 0, 0, 0, 1, 0, 1))
    k = k.reshape(kt, 4, 2, 4, 2, c, f).permute(0, 1, 3, 2, 4, 5, 6)
    return k.reshape(kt, 4, 4, 4 * c, f).permute(4, 3, 0, 1, 2)


def s2d_stem_stage_even(x: torch.Tensor) -> torch.Tensor:
    """`s2d_stem_stage` with its width W/2+3 rounded up to even by zero
    columns on the right: (N, T, H/2+3, W2p, 4C), W2p even.  A staged row
    is then 8C·W2p bytes in bf16, a multiple of 16, so the bf16 kernel
    copies every row in 16-byte chunks.  The extra column feeds no
    output."""
    n, t, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"s2d stem needs even spatial dims, got {h}x{w}")
    extra = 2 * ((w // 2 + 3) % 2)
    xp = F.pad(x, (0, 0, 2, 4 + extra, 2, 4))
    hp, wp = h + 6, w + 6 + extra
    xs = xp.reshape(n, t, hp // 2, 2, wp // 2, 2, c)
    return xs.permute(0, 1, 2, 4, 3, 5, 6).reshape(n, t, hp // 2, wp // 2, 4 * c)


def pack_stem_weights(weight: torch.Tensor) -> torch.Tensor:
    """Canonical (F, C, 7, 7, 7) → (⌈F/32⌉, 7, 32, 16·4C + 8), contiguous:
    for each part of 32 output channels and each temporal tap dt, the rows
    f of `s2d_stem_kernel` with K in the kernel's (dy, dx, ch) order, then
    8 zeros (the bank spread of the kernel's B loads).  Channels past F in
    the last part are zero rows.  One part is the image of a bf16 block's
    resident weights."""
    f = weight.shape[0]
    wk = s2d_stem_kernel(weight).permute(2, 0, 3, 4, 1).reshape(7, f, -1)  # (dt, f, (dy, dx, ch))
    parts = -(-f // PART)
    wk = F.pad(wk, (0, WEIGHT_ROW_PAD, 0, parts * PART - f))
    return wk.reshape(7, parts, PART, -1).permute(1, 0, 2, 3).contiguous()


def _check_shapes(x: torch.Tensor, weight: torch.Tensor) -> None:
    if x.dim() != 5:
        raise ValueError(f"stem_conv_7x7x7_s2: expected (N,T,H,W,C), got {tuple(x.shape)}")
    if weight.dim() != 5 or tuple(weight.shape[1:]) != (x.shape[-1], 7, 7, 7):
        raise ValueError(
            f"stem_conv_7x7x7_s2: weight {tuple(weight.shape)} is not (F, {x.shape[-1]}, 7, 7, 7)"
        )
    if any(n % 2 for n in x.shape[1:4]):
        raise ValueError(f"stem_conv_7x7x7_s2: T, H, W must be even, got {tuple(x.shape[1:4])}")


def stem_conv_7x7x7_s2_reference(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Plain version: NTHWC (N, T, H, W, C) with even T, H, W and the
    canonical (F, C, 7, 7, 7) weight → NTHWC (N, T/2, H/2, W/2, F).  On an
    even axis the TF-SAME pads of a 7-tap stride-2 window are (2, 3): pad
    explicitly, then `F.conv3d`."""
    _check_shapes(x, weight)
    return F.conv3d(_same_padded(x), weight, stride=2).permute(0, 2, 3, 4, 1).contiguous()


def _same_padded(x: torch.Tensor) -> torch.Tensor:
    """NTHWC clips with even T, H, W → NCDHW view with the TF-SAME pads
    (2, 3) of a 7-tap stride-2 window on every axis."""
    return F.pad(x.permute(0, 4, 1, 2, 3), (2, 3, 2, 3, 2, 3))


@torch.library.custom_op("csec::stem_conv_7x7x7_s2", mutates_args=(), device_types="cpu")
def _stem_op(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return stem_conv_7x7x7_s2_reference(x, weight)


def stem_bf16_launch_config(device: torch.device, channels: int, features: int) -> tuple[int, int]:
    """(grid, dynamic shared-memory bytes) of the bf16 kernel on `device`
    for C = `channels` and F = `features`: one block per SM, split evenly
    over the F-parts.  Raises where the kernel does not take them."""
    grid, smem = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        err = load_library().stem_conv_s2d_bf16_config(4 * channels, features, ctypes.byref(grid),
                                                       ctypes.byref(smem))
    check_launch("stem_conv_s2d_bf16_config", err)
    return grid.value, smem.value


def stem_conv_s2d_bf16(xs: torch.Tensor, wp: torch.Tensor, width: int, features: int) -> torch.Tensor:
    """The bf16 kernel on CUDA tensors already staged and packed: xs =
    `s2d_stem_stage_even(x)`, wp = `pack_stem_weights(weight)` for clips of
    width `width` and F = `features` → NTHWC (N, T/2, H/2, W/2, F).
    Counts the launch in `stem_conv_7x7x7_s2.launches`."""
    if xs.dtype != torch.bfloat16 or wp.dtype != torch.bfloat16 or not xs.is_cuda or wp.device != xs.device:
        raise TypeError("stem_conv_s2d_bf16: xs and wp must be bf16 on one CUDA device")
    if not (xs.is_contiguous() and wp.is_contiguous()):
        raise ValueError("stem_conv_s2d_bf16: xs and wp must be contiguous")
    n, t, h2, w2p, c4 = xs.shape
    if wp.shape != (-(-features // PART), 7, PART, 16 * c4 + WEIGHT_ROW_PAD):
        raise ValueError(f"stem_conv_s2d_bf16: wp {tuple(wp.shape)} is not packed for 4C={c4}, F={features}")
    y = torch.empty((n, t // 2, h2 - 3, width // 2, features), dtype=xs.dtype, device=xs.device)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        err = load_library().stem_conv_s2d_bf16(
            xs.data_ptr(), wp.data_ptr(), y.data_ptr(), n, t, h2, w2p, c4, width // 2, features, stream
        )
    check_launch("stem_conv_s2d_bf16", err)
    count_launch(stem_conv_7x7x7_s2)
    return y


@_stem_op.register_kernel("cuda")
def _stem_cuda(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    _check_shapes(x, weight)
    if x.dtype not in (torch.float32, torch.bfloat16) or weight.dtype != x.dtype:
        raise TypeError(f"stem_conv_7x7x7_s2: unsupported dtypes {x.dtype}, {weight.dtype}")
    if not x.is_contiguous():
        raise ValueError("stem_conv_7x7x7_s2: input must be contiguous NTHWC")
    n, t, h, w, c = x.shape
    f = weight.shape[0]
    if x.dtype == torch.bfloat16:
        if c > BF16_MAX_CHANNELS or f % 8 or f > 2 * PART:
            raise ValueError(f"stem_conv_7x7x7_s2: bf16 needs C <= {BF16_MAX_CHANNELS}, F % 8 == 0 and "
                             f"F <= {2 * PART}, got C={c}, F={f}")
        return stem_conv_s2d_bf16(s2d_stem_stage_even(x), pack_stem_weights(weight), w, f)
    if c > MAX_CHANNELS:
        raise ValueError(f"stem_conv_7x7x7_s2: at most {MAX_CHANNELS} input channels, got {c}")
    xs = s2d_stem_stage(x).contiguous()
    wk = s2d_stem_kernel(weight).permute(2, 0, 3, 4, 1).contiguous()  # (7, F, 4, 4, 4C)
    y = torch.empty((n, t // 2, h // 2, w // 2, f), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = load_library().stem_conv_s2d_f32(xs.data_ptr(), wk.data_ptr(), y.data_ptr(), *xs.shape, f, stream)
    check_launch("stem_conv_s2d_f32", err)
    count_launch(stem_conv_7x7x7_s2)
    return y


@_stem_op.register_fake
def _stem_fake(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    n, t, h, w, _ = x.shape
    return torch.empty((n, t // 2, h // 2, w // 2, weight.shape[0]), dtype=x.dtype, device=x.device)


def _stem_setup_context(ctx, inputs, output) -> None:
    ctx.save_for_backward(*inputs)


def _stem_grad(ctx, dy: torch.Tensor):
    """(dx, dweight) of the canonical conv; each only where it is asked for."""
    x, weight = ctx.saved_tensors
    need_x, need_w = ctx.needs_input_grad
    dxp, dw, _ = torch.ops.aten.convolution_backward(
        dy.permute(0, 4, 1, 2, 3), _same_padded(x), weight, None, [2] * 3, [0] * 3, [1] * 3, False,
        [0] * 3, 1, [need_x, need_w, False],
    )
    dx = dxp[:, :, 2:-3, 2:-3, 2:-3].permute(0, 2, 3, 4, 1).contiguous() if need_x else None
    return dx, dw


_stem_op.register_autograd(_stem_grad, setup_context=_stem_setup_context)


def stem_conv_7x7x7_s2(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The 7³ stride-(2,2,2) TF-SAME conv, NTHWC (N, T, H, W, C) × canonical
    (F, C, 7, 7, 7) → NTHWC (N, T/2, H/2, W/2, F); T, H, W even.  No
    BatchNorm, no ReLU; differentiable in x and weight (the canonical
    conv's gradient).  CUDA tensors run a kernel: f32 (C ≤ 4) on
    `s2d_stem_stage(x)`, bf16 (C ≤ 3, F % 8 == 0, F ≤ 64) on
    `s2d_stem_stage_even(x)` and `pack_stem_weights(weight)`; CPU tensors
    run the plain version.  `.launches` counts kernel launches."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"stem_conv_7x7x7_s2: unsupported device {x.device}")
    return _stem_op(x, weight)


stem_conv_7x7x7_s2.launches = 0

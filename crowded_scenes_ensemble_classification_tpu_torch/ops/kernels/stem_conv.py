"""The I3D stem, a 7³ stride-2 TF-SAME conv: the CUDA kernel and its plain version.

Counterpart of the two Pallas TPU kernels that compute this function:
`crowded_scenes_ensemble_classification_tpu/ops/pallas/stem_conv_v8.py`
(`stem_conv_7x7x7_s2_v8`, line 140) and `.../ops/pallas/stem_conv.py`
(`stem_conv_7x7x7_s2`, line 81).  The kernel is `csrc/stem_conv7x7x7s2.cu`,
behind the custom op `csec::stem_conv_7x7x7_s2`.

The kernel reads the spatial space-to-depth staging of the clips
(`s2d_stem_stage`) and the weights rearranged to match (`s2d_stem_kernel`);
both live here, beside the kernel that reads their layout, and
`models/common.py` uses them for the prestaged stem too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import check_launch, load_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHANNELS = 4  # input channels the kernel's shared-memory slab is sized for


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
    xc = F.pad(x.permute(0, 4, 1, 2, 3), (2, 3, 2, 3, 2, 3))
    return F.conv3d(xc, weight, stride=2).permute(0, 2, 3, 4, 1).contiguous()


@torch.library.custom_op("csec::stem_conv_7x7x7_s2", mutates_args=(), device_types="cpu")
def _stem_op(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return stem_conv_7x7x7_s2_reference(x, weight)


@_stem_op.register_kernel("cuda")
def _stem_cuda(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    _check_shapes(x, weight)
    if x.dtype not in _DTYPE_CODES or weight.dtype != x.dtype:
        raise TypeError(f"stem_conv_7x7x7_s2: unsupported dtypes {x.dtype}, {weight.dtype}")
    if not x.is_contiguous():
        raise ValueError("stem_conv_7x7x7_s2: input must be contiguous NTHWC")
    n, t, h, w, c = x.shape
    f = weight.shape[0]
    if c > MAX_CHANNELS:
        raise ValueError(f"stem_conv_7x7x7_s2: at most {MAX_CHANNELS} input channels, got {c}")
    if x.dtype == torch.bfloat16 and (f % 8 or f > 64):
        raise ValueError(f"stem_conv_7x7x7_s2: bf16 needs F % 8 == 0 and F <= 64, got {f}")
    xs = s2d_stem_stage(x).contiguous()
    wk = s2d_stem_kernel(weight).permute(2, 0, 3, 4, 1).contiguous()  # (7, F, 4, 4, 4C)
    y = torch.empty((n, t // 2, h // 2, w // 2, f), dtype=x.dtype, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.stem_conv_s2d(
            xs.data_ptr(), wk.data_ptr(), y.data_ptr(), *xs.shape, f, _DTYPE_CODES[x.dtype], stream
        )
    check_launch("stem_conv_s2d", err)
    stem_conv_7x7x7_s2.launches += 1
    return y


@_stem_op.register_fake
def _stem_fake(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    n, t, h, w, _ = x.shape
    return torch.empty((n, t // 2, h // 2, w // 2, weight.shape[0]), dtype=x.dtype, device=x.device)


def stem_conv_7x7x7_s2(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The 7³ stride-(2,2,2) TF-SAME conv, NTHWC (N, T, H, W, C) × canonical
    (F, C, 7, 7, 7) → NTHWC (N, T/2, H/2, W/2, F); T, H, W even.  No
    BatchNorm, no ReLU.  CUDA tensors (f32 or bf16, C ≤ 4; bf16 needs
    F % 8 == 0 and F ≤ 64) run the kernel on `s2d_stem_stage(x)`; CPU
    tensors run the plain version.  `.launches` counts kernel launches."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"stem_conv_7x7x7_s2: unsupported device {x.device}")
    return _stem_op(x, weight)


stem_conv_7x7x7_s2.launches = 0

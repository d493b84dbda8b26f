"""3×3×3 stride-1 SAME max pool: the CUDA kernel and its plain version.

Counterpart of `crowded_scenes_ensemble_classification_tpu/ops/pallas/maxpool.py`
(`max_pool_3x3x3_same`, line 51).  The kernel is `csrc/maxpool3x3x3.cu`,
behind the custom op `csec::max_pool_3x3x3_same`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import check_launch, load_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def max_pool_3x3x3_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version: (B, T, H, W, C) → same shape, −inf padding then
    `F.max_pool3d(kernel 3, stride 1)`."""
    xc = x.permute(0, 4, 1, 2, 3)  # NCDHW view
    xc = F.pad(xc, (1, 1, 1, 1, 1, 1), value=float("-inf"))
    y = F.max_pool3d(xc, kernel_size=3, stride=1)
    return y.permute(0, 2, 3, 4, 1).contiguous()


@torch.library.custom_op("csec::max_pool_3x3x3_same", mutates_args=(), device_types="cpu")
def _max_pool_op(x: torch.Tensor) -> torch.Tensor:
    return max_pool_3x3x3_reference(x)


@_max_pool_op.register_kernel("cuda")
def _max_pool_cuda(x: torch.Tensor) -> torch.Tensor:
    if x.dim() != 5:
        raise ValueError(f"max_pool_3x3x3_same: expected (B,T,H,W,C), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"max_pool_3x3x3_same: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("max_pool_3x3x3_same: input must be contiguous NTHWC")
    lib = load_library()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.maxpool3x3x3_same(
            x.data_ptr(), y.data_ptr(), *x.shape, _DTYPE_CODES[x.dtype], stream
        )
    check_launch("maxpool3x3x3_same", err)
    max_pool_3x3x3_same.launches += 1
    return y


@_max_pool_op.register_fake
def _max_pool_fake(x: torch.Tensor) -> torch.Tensor:
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


def max_pool_3x3x3_same(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) contiguous → same shape; equals the JAX package's
    `nn.max_pool(x, (3, 3, 3), (1, 1, 1), 'SAME')`.  bf16 or f32.

    CUDA tensors run the kernel; CPU tensors run the plain version.
    `.launches` counts kernel launches, also those of an exported program."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"max_pool_3x3x3_same: unsupported device {x.device}")
    return _max_pool_op(x)


max_pool_3x3x3_same.launches = 0

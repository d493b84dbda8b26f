"""3×3×3 stride-1 SAME max pool: the CUDA kernel, its tiling and its plain version.

Counterpart of `crowded_scenes_ensemble_classification_tpu/ops/pallas/maxpool.py`
(`max_pool_3x3x3_same`, line 51).  The kernel is `csrc/maxpool3x3x3.cu`,
behind the custom op `csec::max_pool_3x3x3_same`; `max_pool_tiling` picks
its tiles.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from ._build import check_launch, load_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HT_MAX, HT_MIN = 8, 4  # output rows of an H-tile: the kernel's register window, and the least chosen
THREADS_MAX = 256  # threads of a block: wt × cv
VECTOR_UNITS, SCALAR_UNITS = 8, 32  # units of a C-block: 128 bytes of 16-byte units, or 32 elements
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class MaxPoolTiling:
    """How the kernel cuts (B, T, H, W, C): one block per (b, H-tile, W-tile,
    C-block), each walking all of T.  A unit is one thread's channels: 16
    bytes (`vector`) or one element."""

    vector: bool
    lanes: int  # channels of a unit
    cv: int  # units of a C-block
    ht: int  # output rows of an H-tile
    wt: int  # output columns of a W-tile
    tiles: tuple[int, int, int, int]  # (B, H-tiles, W-tiles, C-blocks)
    smem: int  # dynamic shared memory, bytes: two planes of (ht+2) × (wt+2) × cv units

    @property
    def cb(self) -> int:
        """Channels of a C-block."""
        return self.cv * self.lanes

    @property
    def grid(self) -> int:
        return math.prod(self.tiles)

    @property
    def threads(self) -> int:
        return self.wt * self.cv

    def tile_origin(self, block: int) -> tuple[int, int, int, int]:
        """(b, h0, w0, c0) of a block, decoded in the kernel's order: the
        C-block fastest, then the W-tile, the H-tile and b."""
        _, tiles_h, tiles_w, c_blocks = self.tiles
        block, cb = divmod(block, c_blocks)
        block, tw = divmod(block, tiles_w)
        b, th = divmod(block, tiles_h)
        return b, th * self.ht, tw * self.wt, cb * self.cb


def max_pool_tiling(shape, itemsize: int, *, aligned: bool = True, sms: int = H100_SMS) -> MaxPoolTiling:
    """The kernel's tiling of a (B, T, H, W, C) tensor of `itemsize`-byte
    elements.  16-byte units where C fills whole 16-byte vectors and the
    pointers are `aligned`, else single elements.  The W-tile is all of W up
    to THREADS_MAX threads; the H-tile is the largest balanced ht ≤ HT_MAX
    whose grid reaches `sms` blocks, or HT_MIN (or H) where none does.
    Raises ValueError for a plane (H·W·C) of 2^31 elements or more: the
    kernel's offsets within a plane are 32-bit."""
    b, _, h, w, c = shape
    if h * w * c >= 2**31:
        raise ValueError(f"max_pool_3x3x3_same: a plane of {h}x{w}x{c} does not fit 32-bit offsets")
    vector = aligned and (c * itemsize) % 16 == 0
    lanes = 16 // itemsize if vector else 1
    unit_bytes = 16 if vector else itemsize
    units = -(-c // lanes)
    cv = min(units, VECTOR_UNITS if vector else SCALAR_UNITS)
    c_blocks = -(-units // cv)
    tiles_w = -(-w // max(1, THREADS_MAX // cv))
    wt = -(-w // tiles_w)
    tiles_w = -(-w // wt)
    for ht in range(min(h, HT_MAX), 0, -1):
        tiles_h = -(-h // ht)
        if ht != -(-h // tiles_h):
            continue  # an unbalanced split: the balanced one with as many tiles comes later
        if b * tiles_h * tiles_w * c_blocks >= sms or ht <= HT_MIN:
            break
    smem = 2 * (ht + 2) * (wt + 2) * cv * unit_bytes
    return MaxPoolTiling(vector, lanes, cv, ht, wt, (b, tiles_h, tiles_w, c_blocks), smem)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    tiling = max_pool_tiling(x.shape, x.element_size(), aligned=(x.data_ptr() | y.data_ptr()) % 16 == 0,
                             sms=_sm_count(x.device.index))
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.maxpool3x3x3_same(
            x.data_ptr(), y.data_ptr(), *x.shape, _DTYPE_CODES[x.dtype], int(tiling.vector),
            tiling.ht, tiling.wt, tiling.cv, stream,
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

"""3×3×3 stride-1 SAME max pool: the CUDA kernels, the tiling and the plain versions.

Counterpart of `crowded_scenes_ensemble_classification_tpu/ops/pallas/maxpool.py`
(`max_pool_3x3x3_same`, line 51).  The kernel is `csrc/maxpool3x3x3.cu`,
behind the custom op `csec::max_pool_3x3x3_same`; `max_pool_tiling` picks
its tiles.  Its gradient is the custom op
`csec::max_pool_3x3x3_same_backward`, the kernel of
`csrc/maxpool3x3x3_bwd.cu` (the JAX package differentiates its pool on
XLA, with no Pallas kernel), tiled by `max_pool_backward_tiling`;
`register_autograd` joins the two, so `backward()` runs through both
kernels.
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
# The gradient kernel's limits: threads (wt + 2) × cv × groups, code rows and
# dx rows a thread walks, and the shared memory of a block.
BWD_THREADS_MAX, BWD_CODE_ROWS, BWD_DX_ROWS, SMEM_MAX = 512, 3, 3, 232_448
BWD_HT_MAX = 8  # rows of dx in an H-tile, at most
BWD_VECTOR_UNITS, BWD_SCALAR_UNITS = 2, 8  # units of a C-block: 32 bytes of 16-byte units, or 8 elements


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


@dataclasses.dataclass(frozen=True)
class MaxPoolBackwardTiling(MaxPoolTiling):
    """How the gradient kernel cuts (B, T, H, W, C): one block per (b,
    H-tile, W-tile, C-block), each walking all of T, as the forward's.  Its
    threads are `groups` row groups of (wt + 2) columns × cv units: group g
    walks code rows [3g, 3g + 3) of the (ht + 2) × (wt + 2) outputs the
    tile's gather reads and sums dx rows [g·dx_rows, g·dx_rows + 3)."""

    groups: int = 1

    @property
    def threads(self) -> int:
        return (self.wt + 2) * self.cv * self.groups

    @property
    def dx_rows(self) -> int:
        return -(-self.ht // self.groups)


def backward_slot_rows(ht: int, groups: int) -> tuple[int, int]:
    """Rows of the gradient kernel's x slots and of its dy and code slots:
    each of `groups` row groups walks 3 code rows and sums 3 dx rows
    wherever the tile ends, so the slots reach as deep as the last group
    reads (ht + 4 and ht + 2 rows hold the tile with its halos)."""
    dx_rows = -(-ht // groups)
    return groups * BWD_CODE_ROWS + 2, max(groups * BWD_CODE_ROWS, (groups - 1) * dx_rows + BWD_DX_ROWS + 2)


def max_pool_backward_tile(shape, itemsize: int, vector: bool, cv: int, ht: int) -> MaxPoolBackwardTiling:
    """The gradient kernel's tiling of a (B, T, H, W, C) tensor with `cv`
    units a C-block and H-tiles of `ht` rows: the fewest row groups that
    keep a thread to 3 code rows (and so to 3 dx rows), W-tiles as wide as
    512 threads allow, and the shared memory of two x slots, four dy slots
    and five code slots (one byte a channel; the fifth stands for the
    planes outside T) of `backward_slot_rows` rows.  Raises ValueError where
    the kernel does not take it."""
    b, _, h, w, c = shape
    lanes = 16 // itemsize if vector else 1
    unit_bytes = 16 if vector else itemsize
    units = -(-c // lanes)
    groups = -(-(ht + 2) // BWD_CODE_ROWS)
    wt_max = BWD_THREADS_MAX // (cv * groups) - 2
    if not (1 <= cv <= units and 1 <= ht and wt_max >= 1):
        raise ValueError(f"max_pool_3x3x3_same_backward: no tile of {ht} rows and {cv} units for {tuple(shape)}")
    tiles_w = -(-w // wt_max)
    wt = -(-w // tiles_w)
    tiles = (b, -(-h // ht), -(-w // wt), -(-units // cv))
    x_plane, q_plane = backward_slot_rows(ht, groups)
    x_plane, q_plane = x_plane * (wt + 4) * cv, q_plane * (wt + 2) * cv
    smem = (2 * x_plane + 4 * q_plane) * unit_bytes + 5 * q_plane * lanes
    if smem > SMEM_MAX:
        raise ValueError(f"max_pool_3x3x3_same_backward: a tile of {ht} rows and {cv} units needs {smem} B")
    return MaxPoolBackwardTiling(vector, lanes, cv, ht, wt, tiles, smem, groups)


def max_pool_backward_tiling(shape, itemsize: int, *, aligned: bool = True,
                             sms: int = H100_SMS) -> MaxPoolBackwardTiling:
    """The gradient kernel's tiling of a (B, T, H, W, C) tensor of
    `itemsize`-byte elements: 16-byte units where C fills whole 16-byte
    vectors and every pointer is `aligned`, else single elements; C-blocks of
    32 bytes (8 elements in the scalar variant); the largest balanced H-tile
    of at most 8 rows whose grid reaches `sms` blocks, or 4 rows (or H)
    where none does.  Raises ValueError for a plane (H·W·C) of 2^31
    elements or more."""
    _, _, h, _, c = shape
    if h * shape[3] * c >= 2**31:
        raise ValueError(f"max_pool_3x3x3_same_backward: a plane of {h}x{shape[3]}x{c} does not fit 32-bit offsets")
    vector = aligned and (c * itemsize) % 16 == 0
    units = -(-c // (16 // itemsize if vector else 1))
    cv = min(units, BWD_VECTOR_UNITS if vector else BWD_SCALAR_UNITS)
    for ht in range(min(h, BWD_HT_MAX), 0, -1):
        if ht != -(-h // -(-h // ht)):
            continue  # an unbalanced split: the balanced one with as many tiles comes later
        tiling = max_pool_backward_tile(shape, itemsize, vector, cv, ht)
        if tiling.grid >= sms or ht <= HT_MIN:
            return tiling
    return tiling


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


def max_pool_3x3x3_backward_reference(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain version of the gradient: the autograd formula of
    `F.max_pool3d` on the −inf-padded input (x, dy (B, T, H, W, C) → dx of
    the same shape).  Each output's gradient goes to the first maximum of
    its window in (t, h, w) order, as `jax.vjp` of the JAX package's pool
    sends it."""
    to_ncdhw = lambda t: t.permute(0, 4, 1, 2, 3)  # noqa: E731
    xp = F.pad(to_ncdhw(x), (1, 1, 1, 1, 1, 1), value=float("-inf"))
    window, stride, pad, dilation = [3] * 3, [1] * 3, [0] * 3, [1] * 3
    _, indices = torch.ops.aten.max_pool3d_with_indices(xp, window, stride, pad, dilation, False)
    dxp = torch.ops.aten.max_pool3d_with_indices_backward(
        to_ncdhw(dy), xp, window, stride, pad, dilation, False, indices
    )
    return dxp[:, :, 1:-1, 1:-1, 1:-1].permute(0, 2, 3, 4, 1).contiguous()


@torch.library.custom_op("csec::max_pool_3x3x3_same_backward", mutates_args=(), device_types="cpu")
def _max_pool_backward_op(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    return max_pool_3x3x3_backward_reference(x, dy)


@_max_pool_backward_op.register_kernel("cuda")
def _max_pool_backward_cuda(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    if x.dim() != 5 or dy.shape != x.shape:
        raise ValueError(f"max_pool_3x3x3_same_backward: x {tuple(x.shape)} and dy {tuple(dy.shape)} "
                         "must both be (B,T,H,W,C)")
    if x.dtype not in _DTYPE_CODES or dy.dtype != x.dtype:
        raise TypeError(f"max_pool_3x3x3_same_backward: unsupported dtypes {x.dtype}, {dy.dtype}")
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("max_pool_3x3x3_same_backward: x and dy must be contiguous NTHWC")
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    pointers = (x.data_ptr(), dy.data_ptr(), dx.data_ptr())
    tiling = max_pool_backward_tiling(x.shape, x.element_size(), aligned=all(p % 16 == 0 for p in pointers),
                                      sms=_sm_count(x.device.index))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = load_library().maxpool3x3x3_same_backward(
            *pointers, *x.shape, _DTYPE_CODES[x.dtype], int(tiling.vector), tiling.ht, tiling.wt, tiling.cv,
            tiling.groups, stream,
        )
    check_launch("maxpool3x3x3_same_backward", err)
    max_pool_3x3x3_same_backward.launches += 1
    return dx


@_max_pool_backward_op.register_fake
def _max_pool_backward_fake(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


def _max_pool_setup_context(ctx, inputs, output) -> None:
    ctx.save_for_backward(inputs[0])


def _max_pool_grad(ctx, dy: torch.Tensor) -> torch.Tensor:
    (x,) = ctx.saved_tensors
    return _max_pool_backward_op(x, dy.contiguous())


_max_pool_op.register_autograd(_max_pool_grad, setup_context=_max_pool_setup_context)


def max_pool_3x3x3_same(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) contiguous → same shape; equals the JAX package's
    `nn.max_pool(x, (3, 3, 3), (1, 1, 1), 'SAME')`.  bf16 or f32.

    CUDA tensors run the kernel; CPU tensors run the plain version; both
    differentiate through `max_pool_3x3x3_same_backward`.  `.launches`
    counts kernel launches, also those of an exported program."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"max_pool_3x3x3_same: unsupported device {x.device}")
    return _max_pool_op(x)


def max_pool_3x3x3_same_backward(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The pool's gradient: x, dy (B, T, H, W, C) contiguous → dx, dy of
    each output summed into the first maximum of its window in (t, h, w)
    order.  bf16 or f32, summed in f32.  CUDA tensors run the kernel (one
    pass: argmax codes in shared memory, then a gather in a fixed order, so
    deterministic); CPU tensors run the plain version.  `.launches` counts
    kernel launches (one a call)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"max_pool_3x3x3_same_backward: unsupported device {x.device}")
    return _max_pool_backward_op(x, dy)


max_pool_3x3x3_same.launches = 0
max_pool_3x3x3_same_backward.launches = 0

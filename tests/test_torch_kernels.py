"""The port's kernel modules on the CPU: plain versions against the JAX
package's Pallas kernels run in interpret mode (as tests/test_pallas_ops.py
runs them), the TF-SAME pools against flax, and the wrappers' routing.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
and chip_smoke.py hold them against these plain versions there.  torch
and the port are imported by fixtures, not at collection
(tests/torch_port_memory.py)."""

import importlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from crowded_scenes_ensemble_classification_tpu.models.common import max_pool_3d as j_max_pool_3d
from crowded_scenes_ensemble_classification_tpu.ops.pallas import maxpool as jmaxpool
from torch_port_memory import release_heap_after_module, torch  # noqa: F401 (fixtures)

PORT = "crowded_scenes_ensemble_classification_tpu_torch"


@pytest.fixture(scope="module")
def maxpool(torch):
    return importlib.import_module(f"{PORT}.ops.kernels.maxpool")


@pytest.fixture(scope="module")
def noise(torch):
    return importlib.import_module(f"{PORT}.ops.kernels.noise")


@pytest.fixture(scope="module")
def stem(torch):
    return importlib.import_module(f"{PORT}.ops.kernels.stem_conv")


@pytest.fixture(scope="module")
def tcommon(torch):
    return importlib.import_module(f"{PORT}.models.common")


def _pallas_maxpool_interpret(x: jax.Array) -> jax.Array:
    """The Pallas max-pool kernel body in interpret mode, full-C slabs
    (the grid of tests/test_pallas_ops.py:99-126)."""
    b, t, h, w, c = x.shape
    slab = (1, 1, h, w, c)

    def idx(shift):
        return lambda i, j: (i, jnp.clip(j + shift, 0, t - 1), 0, 0, 0)

    return pl.pallas_call(
        jmaxpool._maxpool3_kernel,
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        grid=(b, t),
        in_specs=[pl.BlockSpec(slab, idx(s), memory_space=pltpu.VMEM) for s in (-1, 0, 1)],
        out_specs=pl.BlockSpec(slab, lambda i, j: (i, j, 0, 0, 0), memory_space=pltpu.VMEM),
        interpret=pltpu.InterpretParams(),
    )(x, x, x)


@pytest.mark.parametrize("shape", [(2, 5, 8, 8, 16), (1, 1, 3, 3, 3), (1, 3, 5, 7, 130)])
def test_maxpool_reference_matches_pallas_interpret(torch, maxpool, shape):
    """Plain version == the Pallas kernel (interpret) == nn.max_pool, exactly:
    a max of the same values.  T=1, C=3 and C=130 are the odd cases."""
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    kernel = np.asarray(_pallas_maxpool_interpret(jnp.asarray(x)))
    flax_ref = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3, 3), (1, 1, 1), "SAME"))
    got = maxpool.max_pool_3x3x3_reference(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, kernel)
    np.testing.assert_array_equal(got, flax_ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_maxpool_wrapper_on_cpu_is_the_plain_version(torch, maxpool, dtype):
    """A CPU tensor takes the plain version and counts no launch; bf16 is
    exact too (a max of the inputs)."""
    x = torch.randn(2, 4, 6, 5, 24, generator=torch.Generator().manual_seed(1)).to(getattr(torch, dtype))
    before = maxpool.max_pool_3x3x3_same.launches
    got = maxpool.max_pool_3x3x3_same(x)
    assert maxpool.max_pool_3x3x3_same.launches == before
    ref = fnn.max_pool(jnp.asarray(x.float().numpy(), getattr(jnp, dtype)), (3, 3, 3), (1, 1, 1), "SAME")
    assert got.dtype == x.dtype and got.shape == x.shape
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


# (B, T, H, W, C) of the 3³/1 pool branch of the 9 Mixed blocks at 20×224², B=16
# (chip_smoke.py's POOL_SHAPES), and shapes the tiler has to mask: T=1 and 2,
# C not a multiple of the 16-byte unit (3, 130 f32 and bf16), H not a
# multiple of the H-tile (30, 14 at B=2, 5), a partial last C-block (528).
MIXED_POOL_SHAPES = {
    "Mixed_3b": (16, 10, 28, 28, 192), "Mixed_3c": (16, 10, 28, 28, 256),
    "Mixed_4b": (16, 5, 14, 14, 480), "Mixed_4c": (16, 5, 14, 14, 512), "Mixed_4d": (16, 5, 14, 14, 512),
    "Mixed_4e": (16, 5, 14, 14, 512), "Mixed_4f": (16, 5, 14, 14, 528),
    "Mixed_5b": (16, 3, 7, 7, 832), "Mixed_5c": (16, 3, 7, 7, 832),
}
ODD_POOL_SHAPES = [(2, 1, 5, 5, 64), (2, 3, 5, 7, 3), (2, 3, 5, 7, 130), (2, 4, 30, 28, 64),
                   (2, 5, 14, 14, 528), (1, 2, 6, 6, 16)]
POOL_CASES = [pytest.param(s, id=name) for name, s in MIXED_POOL_SHAPES.items()] + [
    pytest.param(s, id="x".join(map(str, s))) for s in ODD_POOL_SHAPES]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", POOL_CASES)
def test_maxpool_tiling_covers_every_output_once(torch, maxpool, shape, dtype):
    """The kernel's tiles, decoded in its block order, cover every (b, h, w,
    c) output exactly once, no block starts past the tensor, a block fits
    the kernel's limits (≤ 256 threads, ≤ 8 rows, ≤ 232,448 B of shared
    memory, which is two planes of the tile with its halo), and every
    main-path shape gets at least one block per SM of an H100."""
    tiling = maxpool.max_pool_tiling(shape, getattr(torch, dtype).itemsize)
    b, _, h, w, c = shape
    count = np.zeros((b, h, w, c), np.int32)
    for block in range(tiling.grid):
        b0, h0, w0, c0 = tiling.tile_origin(block)
        assert b0 < b and h0 < h and w0 < w and c0 < c
        count[b0, h0 : h0 + tiling.ht, w0 : w0 + tiling.wt, c0 : c0 + tiling.cb] += 1
    assert (count == 1).all()
    unit_bytes = 16 if tiling.vector else getattr(torch, dtype).itemsize
    assert tiling.smem == 2 * (tiling.ht + 2) * (tiling.wt + 2) * tiling.cv * unit_bytes <= 232_448
    assert tiling.threads <= 256 and 1 <= tiling.ht <= 8 and tiling.wt <= w
    if shape in MIXED_POOL_SHAPES.values():
        assert tiling.grid >= 132 and tiling.vector and tiling.wt == w


def test_maxpool_tiling_units_and_limits(torch, maxpool):
    """16-byte units only where C fills whole vectors and both pointers are
    aligned, single elements otherwise; a plane of 2^31 elements raises."""
    bf16 = maxpool.max_pool_tiling((1, 2, 4, 4, 64), 2)
    assert bf16.vector and bf16.lanes == 8
    assert maxpool.max_pool_tiling((1, 2, 4, 4, 64), 4).lanes == 4
    assert not maxpool.max_pool_tiling((1, 2, 4, 4, 64), 2, aligned=False).vector
    assert not maxpool.max_pool_tiling((1, 2, 4, 4, 130), 4).vector  # 520 B: not whole 16-byte units
    assert not maxpool.max_pool_tiling((1, 2, 4, 4, 3), 2).vector
    assert maxpool.max_pool_tiling((1, 2, 4, 4, 3), 2).cv == 3
    with pytest.raises(ValueError):
        maxpool.max_pool_tiling((1, 1, 2**16, 2**10, 32), 2)


def _emulate_maxpool_kernel(torch, x, tiling):
    """The kernel's algorithm in torch, block by block, in its block order:
    per plane t, copy rows h0-1..h0+ht and columns w0-1..w0+wt of the tile
    into buffer t % 2, one plane ahead of its reduction (positions outside
    the tensor are not copied), reduce each row over w-1..w+1 (skipping
    columns outside the tensor) and then three rows, and keep P1 = S[t-1]
    and P2 = max(S[t-2],
    S[t-1]) to write y[t-1] = max(P2, S[t]); y[T-1] = P2.  The buffers start
    as NaN and so does y: a read of a position the kernel does not copy,
    or an output no block writes, shows as NaN."""
    nan, ninf = float("nan"), float("-inf")
    _, t_len, h, w, c = x.shape
    ht, wt = tiling.ht, tiling.wt
    y = torch.full_like(x, nan)
    for block in range(tiling.grid):
        b, h0, w0, c0 = tiling.tile_origin(block)
        cs = slice(c0, min(c0 + tiling.cb, c))
        smem = torch.full((2, ht + 2, wt + 2, cs.stop - c0), nan, dtype=x.dtype)

        def copy(t, s, b=b, h0=h0, w0=w0, cs=cs, smem=smem):
            lo, hi = max(w0 - 1, 0), min(w0 + wt + 1, w)
            for r in range(ht + 2):
                if 0 <= h0 - 1 + r < h:
                    smem[s, r, lo - w0 + 1 : hi - w0 + 1] = x[b, t, h0 - 1 + r, lo:hi, cs]

        cols = w0 + torch.arange(wt)[:, None]  # the threads' columns w
        rows_in = [0 <= h0 - 1 + r < h for r in range(ht + 2)]
        p1 = p2 = torch.full((ht, wt, cs.stop - c0), ninf, dtype=x.dtype)
        nh, nw = min(ht, h - h0), min(wt, w - w0)
        copy(0, 0)
        for t in range(t_len):
            if t + 1 < t_len:
                copy(t + 1, (t + 1) % 2)
            src = smem[t % 2]
            m = torch.maximum(src[:, 1 : wt + 1], torch.where(cols > 0, src[:, :wt], ninf))
            m = torch.maximum(m, torch.where(cols + 1 < w, src[:, 2:], ninf))
            m = torch.stack([m[r] if rows_in[r] else torch.full_like(m[r], ninf) for r in range(ht + 2)])
            s = torch.maximum(torch.maximum(m[:-2], m[1:-1]), m[2:])
            if t > 0:
                y[b, t - 1, h0 : h0 + nh, w0 : w0 + nw, cs] = torch.maximum(p2, s)[:nh, :nw]
            p1, p2 = s, torch.maximum(p1, s)
        y[b, t_len - 1, h0 : h0 + nh, w0 : w0 + nw, cs] = p2[:nh, :nw]
    return y


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "shape,sms",
    [((2, 10, 28, 28, 64), 1), ((2, 5, 14, 14, 528), 1), ((2, 3, 7, 7, 96), 1)]  # the Mixed tiles, B=2
    + [(s, 132) for s in ODD_POOL_SHAPES],
)
def test_maxpool_kernel_emulation_equals_plain(torch, maxpool, shape, sms, dtype, aligned):
    """The kernel's algorithm, emulated over its tiling, equals the plain
    version exactly: at the Mixed blocks' tiles (ht = 7, all of W, a
    partial C-block at 528) and at the odd shapes, with 16-byte or single
    element units."""
    x = torch.from_numpy(np.random.default_rng(4).normal(size=shape).astype(np.float32)).to(getattr(torch, dtype))
    tiling = maxpool.max_pool_tiling(shape, x.element_size(), aligned=aligned, sms=sms)
    assert torch.equal(_emulate_maxpool_kernel(torch, x, tiling), maxpool.max_pool_3x3x3_reference(x))


def test_maxpool_kernel_emulation_propagates_nan(torch, maxpool):
    """A NaN on an H-tile's halo row (the first row of the next tile) and
    NaNs in the first and last planes come out where the plain version puts
    them, and nowhere else."""
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 4, 30, 28, 64)).astype(np.float32))
    tiling = maxpool.max_pool_tiling(x.shape, 4)
    assert tiling.ht < 30
    x[1, 1, tiling.ht, 5, 3] = x[0, 0, 0, 0, 0] = x[0, 3, 29, 27, 63] = float("nan")
    got, ref = _emulate_maxpool_kernel(torch, x, tiling), maxpool.max_pool_3x3x3_reference(x)
    assert torch.equal(got.isnan(), ref.isnan()) and int(ref.isnan().sum()) == 27 + 8 + 8
    assert torch.equal(got.nan_to_num(), ref.nan_to_num())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", POOL_CASES)
def test_maxpool_backward_tiling_covers_every_input_once(torch, maxpool, shape, dtype):
    """The gradient kernel's tiles, decoded in its block order, cover every
    (b, h, w, c) input exactly once; a block fits the kernel's limits (≤ 512
    threads, ≤ 3 code rows and 3 dx rows a thread, ≤ 232,448 B of shared
    memory: two x slots with a 2-halo, four dy and five code slots with a
    1-halo, as deep as the last row group reads); every main-path shape gets
    at least one block per SM of an H100 in 16-byte units, all of W in a
    tile."""
    tiling = maxpool.max_pool_backward_tiling(shape, getattr(torch, dtype).itemsize)
    b, _, h, w, c = shape
    count = np.zeros((b, h, w, c), np.int32)
    for block in range(tiling.grid):
        b0, h0, w0, c0 = tiling.tile_origin(block)
        assert b0 < b and h0 < h and w0 < w and c0 < c
        count[b0, h0 : h0 + tiling.ht, w0 : w0 + tiling.wt, c0 : c0 + tiling.cb] += 1
    assert (count == 1).all()
    unit_bytes = 16 if tiling.vector else getattr(torch, dtype).itemsize
    x_rows, q_rows = maxpool.backward_slot_rows(tiling.ht, tiling.groups)
    assert x_rows >= tiling.ht + 4 and q_rows >= tiling.ht + 2
    assert q_rows >= (tiling.groups - 1) * tiling.dx_rows + 3 + 2  # the last group's gather stays in its slots
    x_plane, q_plane = x_rows * (tiling.wt + 4) * tiling.cv, q_rows * (tiling.wt + 2) * tiling.cv
    assert tiling.smem == (2 * x_plane + 4 * q_plane) * unit_bytes + 5 * q_plane * tiling.lanes <= 232_448
    assert tiling.threads <= 512 and tiling.dx_rows <= 3 and tiling.wt <= w
    assert tiling.groups * 3 >= tiling.ht + 2 and tiling.groups * tiling.dx_rows >= tiling.ht
    if shape in MIXED_POOL_SHAPES.values():
        assert tiling.grid >= 132 and tiling.vector and tiling.wt == w


def test_maxpool_backward_tiling_units_and_limits(torch, maxpool):
    """16-byte units only where C fills whole vectors and every pointer is
    aligned; a plane of 2^31 elements raises; B·T has no limit of its own
    (the grid is 1-D over tiles, which do not count T)."""
    assert maxpool.max_pool_backward_tiling((1, 2, 4, 4, 64), 2).lanes == 8
    assert maxpool.max_pool_backward_tiling((1, 2, 4, 4, 64), 4).lanes == 4
    assert not maxpool.max_pool_backward_tiling((1, 2, 4, 4, 64), 2, aligned=False).vector
    assert not maxpool.max_pool_backward_tiling((1, 2, 4, 4, 130), 4).vector
    assert maxpool.max_pool_backward_tiling((4100, 16, 2, 2, 8), 2).grid == 4100
    with pytest.raises(ValueError):
        maxpool.max_pool_backward_tiling((1, 1, 2**16, 2**10, 32), 2)
    with pytest.raises(ValueError):  # 32 units a C-block need more shared memory than a block has
        maxpool.max_pool_backward_tile((1, 2, 28, 28, 256), 2, True, 32, 8)


def _emulate_maxpool_backward_kernel(torch, x, dy, tiling):
    """The gradient kernel's algorithm in torch, block by block in its block
    order.  Shared memory starts as the kernel fills it: x slots −inf, dy
    slots 0, code slots 255 (no neighbour asks for that code); copies write
    only positions inside the tensor.  Step s: x plane s+1 into slot
    (s+1) % 2 and dy plane s-1 into slot (s-1) % 4; the spatial argmax S[s]
    of x slot s % 2 by scans over kw, then kh, each by "replace if greater
    or NaN" in (t, h, w) order; code plane s-1 = P2 ⊕ S[s] (P2 alone at
    s = T) into code slot (s-1) % 4 at the outputs inside the tensor, with
    P2 = P1 ⊕ S[s], P1 = S[s]; dx plane s-3 summed in f32 over the 27
    neighbours in k order from the code and dy slots of planes s-4 .. s-2
    (a plane outside T reads the fifth code slot, never written).  dx
    starts as NaN: an input no block writes shows."""
    ninf = float("-inf")
    _, t_len, h, w, c = x.shape
    ht, wt = tiling.ht, tiling.wt
    dx = torch.full_like(x, float("nan"))

    def take(m, code, v, k):  # a chunk (v, k) replaces (m, code) where v > m or v is NaN
        r = (v > m) | v.isnan()
        return torch.where(r, v, m), torch.where(r, k, code)

    def inside(lo, n, size):  # the part of rows (or columns) lo .. lo+n-1 inside the tensor
        a, z = max(lo, 0), min(lo + n, size)
        return slice(a - lo, z - lo), slice(a, z)

    for block in range(tiling.grid):
        b, h0, w0, c0 = tiling.tile_origin(block)
        cs = slice(c0, min(c0 + tiling.cb, c))
        n = cs.stop - c0
        xs = torch.full((2, ht + 4, wt + 4, n), ninf)
        gs = torch.zeros((4, ht + 2, wt + 2, n))
        codes = torch.full((5, ht + 2, wt + 2, n), 255, dtype=torch.int64)
        (xr, xh), (xc, xw) = inside(h0 - 2, ht + 4, h), inside(w0 - 2, wt + 4, w)
        (qr, qh), (qc, qw) = inside(h0 - 1, ht + 2, h), inside(w0 - 1, wt + 2, w)
        none = torch.full((ht + 2, wt + 2, n), ninf), torch.zeros((ht + 2, wt + 2, n), dtype=torch.int64)
        (p1v, p1c), (p2v, p2c) = none, none

        xs[0, xr, xc] = x[b, 0, xh, xw, cs]
        for s in range(t_len + 3):
            if s + 1 < t_len:
                xs[(s + 1) % 2, xr, xc] = x[b, s + 1, xh, xw, cs]
            if 1 <= s <= t_len:
                gs[(s - 1) % 4, qr, qc] = dy[b, s - 1, qh, qw, cs].float()
            if s <= t_len:
                code_c = p2c
                if s < t_len:
                    xp = xs[s % 2]
                    rv, rc = xp[:, : wt + 2], torch.zeros_like(xp[:, : wt + 2], dtype=torch.int64)
                    rv, rc = take(rv, rc, xp[:, 1 : wt + 3], 1)
                    rv, rc = take(rv, rc, xp[:, 2:], 2)
                    sv, sc = take(*take(rv[: ht + 2], rc[: ht + 2], rv[1 : ht + 3], rc[1 : ht + 3] + 3),
                                  rv[2:], rc[2:] + 6)
                    _, code_c = take(p2v, p2c, sv, sc + 18)
                    (p2v, p2c), (p1v, p1c) = take(p1v, p1c, sv, sc + 9), (sv, sc)
                if s >= 1:
                    codes[(s - 1) % 4, qr, qc] = code_c[qr, qc]
            if s >= 3:
                t = s - 3
                acc = torch.zeros((ht, wt, n))
                for dt in range(3):
                    in_t = 0 <= t - 1 + dt < t_len
                    cslot, gslot = ((t - 1 + dt) % 4,) * 2 if in_t else (4, 0)
                    for dh in range(3):
                        for dw in range(3):
                            hit = codes[cslot, dh : dh + ht, dw : dw + wt] == 9 * (2 - dt) + 3 * (2 - dh) + (2 - dw)
                            acc = acc + torch.where(hit, gs[gslot, dh : dh + ht, dw : dw + wt], 0.0)
                nh, nw = min(ht, h - h0), min(wt, w - w0)
                dx[b, t, h0 : h0 + nh, w0 : w0 + nw, cs] = acc[:nh, :nw].to(x.dtype)
    return dx


def _tie_heavy_x(rng, shape):
    """Integer x in 0..3 with the first half of H zeroed: ties and the ReLU
    plateau (chip_smoke.py's `tie_heavy`)."""
    x = rng.integers(-3, 4, shape).clip(0).astype(np.float32)
    x[:, :, : shape[2] // 2] = 0
    return x


def _neg_inf_region(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    x[:, :2, :4, :5] = -np.inf  # a corner: windows of nothing but −inf and padding
    x[:, -1, 2:, 1:4, : shape[-1] // 2] = -np.inf
    return x


def _nan_at_edges(rng, shape, tiling):
    """Tie-heavy x with NaNs on the first row of the second H-tile, on the
    first and last channel of a C-block boundary, and next to −inf."""
    x = _tie_heavy_x(rng, shape)
    b, t, h, w, c = shape
    x[0, 1, tiling.ht, 3, tiling.cb - 1] = x[0, 1, tiling.ht - 1, 4, tiling.cb] = np.nan
    x[b - 1, t - 1, h - 1, w - 1, c - 1] = x[0, 0, 0, 0, 0] = np.nan
    x[0, 2, tiling.ht + 1, 5:8, tiling.cb] = [np.nan, 1.0, np.nan]  # two NaNs in one window: the last wins
    x[b - 1, 0, 1:3, 1:3, :] = -np.inf
    return x


# (id, shape, x maker, sms, aligned): the Mixed_3* tile (sms=1 makes ht 7),
# T = 1 and 2, C = 3 and 130 (single elements; 130 a partial C-block), 12 f32
# (three 16-byte units: a partial C-block of units), 528, H = 30, W = 45 in
# W-tiles of 23 (a ragged last one), a −inf region, NaNs across tile edges.
BACKWARD_EMULATION_CASES = [
    ("tie_mixed_3", (1, 10, 28, 28, 16), _tie_heavy_x, 1, True),
    ("tie_T1", (2, 1, 5, 5, 64), _tie_heavy_x, 132, True),
    ("tie_T2", (1, 2, 6, 6, 16), _tie_heavy_x, 132, True),
    ("C3", (2, 3, 5, 7, 3), _tie_heavy_x, 132, True),
    ("C130", (1, 3, 5, 7, 130), _tie_heavy_x, 132, True),
    ("C12", (2, 3, 4, 6, 12), _tie_heavy_x, 132, True),
    ("C528", (1, 5, 14, 14, 528), _tie_heavy_x, 132, True),
    ("H30", (1, 4, 30, 28, 32), _tie_heavy_x, 132, True),
    ("W45_ragged", (1, 3, 9, 45, 8), _tie_heavy_x, 132, False),
    ("neg_inf", (2, 4, 9, 10, 16), _neg_inf_region, 132, True),
    ("neg_inf_scalar", (1, 3, 7, 9, 5), _neg_inf_region, 132, True),
    ("nan_edges", (2, 4, 30, 28, 32), "nan", 132, True),
    ("nan_edges_scalar", (1, 4, 16, 12, 20), "nan", 132, False),
]


@pytest.mark.parametrize("case", BACKWARD_EMULATION_CASES, ids=[c[0] for c in BACKWARD_EMULATION_CASES])
def test_maxpool_backward_kernel_emulation_equals_plain(torch, maxpool, case):
    """The gradient kernel's algorithm, emulated over its tiling (halo,
    rings, separable argmax, fixed-order sum), is `torch.equal` to the plain
    version in f32 with dy in multiples of 1/8 (sums exact in any order):
    tie-heavy x, −inf regions, NaNs across H-tile and C-block edges, and
    the ragged shapes."""
    _, shape, make_x, sms, aligned = case
    rng = np.random.default_rng(12)
    tiling = maxpool.max_pool_backward_tiling(shape, 4, aligned=aligned, sms=sms)
    x = _nan_at_edges(rng, shape, tiling) if make_x == "nan" else make_x(rng, shape)
    dy = torch.from_numpy(rng.integers(-8, 8, shape).astype(np.float32) / 8)
    x = torch.from_numpy(x)
    if case[0] == "W45_ragged":
        assert tiling.tiles[2] > 1 and tiling.wt * tiling.tiles[2] > shape[3] and not tiling.vector
    if case[0] in ("C130", "C12"):
        assert tiling.tiles[3] * tiling.cb > shape[4]
    if case[0].startswith("nan"):
        assert tiling.ht < shape[2] and tiling.cb < shape[4] and x.isnan().any()
    got = _emulate_maxpool_backward_kernel(torch, x, dy, tiling)
    assert torch.equal(got, maxpool.max_pool_3x3x3_backward_reference(x, dy))


@pytest.mark.parametrize(
    "window,strides,shape",
    [
        ((1, 3, 3), (1, 2, 2), (1, 3, 8, 8, 4)),  # even H, W: pads (0, 1)
        ((1, 3, 3), (1, 2, 2), (1, 3, 7, 9, 4)),  # odd H, W: pads (1, 1)
        ((3, 3, 3), (2, 2, 2), (2, 5, 7, 6, 4)),
        ((3, 3, 3), (2, 2, 2), (1, 10, 28, 28, 4)),  # the 224-input geometry
        ((2, 2, 2), (2, 2, 2), (1, 5, 14, 14, 4)),  # T=5: pads (0, 1)
        ((2, 2, 2), (2, 2, 2), (1, 4, 7, 7, 4)),
    ],
)
def test_tf_same_pools_match_flax(torch, window, strides, shape):
    """The trunk's strided TF-SAME max pools, −inf padded explicitly:
    array_equal with flax's SAME pool, windows unshifted."""
    from crowded_scenes_ensemble_classification_tpu_torch.models.common import (
        max_pool_3d,
        to_ncdhw,
        to_nthwc,
    )

    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    ref = np.asarray(j_max_pool_3d(jnp.asarray(x), window, strides, "SAME"))
    got = to_nthwc(max_pool_3d(to_ncdhw(torch.from_numpy(x)), window, strides)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_wrappers_refuse_devices_they_do_not_run(torch, maxpool, noise, stem):
    """No silent fallback: a tensor that is neither CPU nor CUDA raises."""
    x = torch.empty(1, 2, 3, 3, 8, device="meta")
    with pytest.raises(ValueError):
        maxpool.max_pool_3x3x3_same(x)
    gates = torch.zeros(1, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        noise.salt_pepper(x, 1, gates, gates, 100)
    with pytest.raises(ValueError):
        stem.stem_conv_7x7x7_s2(torch.empty(1, 2, 4, 4, 3, device="meta"),
                                torch.empty(8, 3, 7, 7, 7, device="meta"))


# ----------------------------------------------------------------------
# the 7³/2 stem
# ----------------------------------------------------------------------


def _stem_inputs(torch, x_shape, features, seed):
    """numpy-seeded clips and a DHWIO kernel (JAX layout), with the kernel
    also as the port's OIDHW tensor."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0, x_shape).astype(np.float32)
    k = rng.normal(0.0, 0.1, (7, 7, 7, x_shape[-1], features)).astype(np.float32)
    return x, k, torch.from_numpy(np.ascontiguousarray(k.transpose(4, 3, 0, 1, 2)))


@pytest.mark.parametrize("assembly", ["concat", "scratch"])
def test_stem_reference_matches_pallas_v8_interpret(torch, stem, assembly):
    """Plain stem == the Pallas v8 kernel (interpret) at (2,4,28,28,3) ×
    (7,7,7,3,16), atol 1e-5: f32 sums of 1029 products in another order
    (the bound of tests/test_pallas_ops.py:161-176)."""
    from crowded_scenes_ensemble_classification_tpu.ops.pallas.stem_conv_v8 import (
        stem_conv_7x7x7_s2_v8,
    )

    x, k, w = _stem_inputs(torch, (2, 4, 28, 28, 3), 16, seed=5)
    ref = np.asarray(stem_conv_7x7x7_s2_v8(jnp.asarray(x), jnp.asarray(k), assembly=assembly, interpret=True))
    got = stem.stem_conv_7x7x7_s2_reference(torch.from_numpy(x), w).numpy()
    assert got.shape == ref.shape == (2, 2, 14, 14, 16)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_stem_reference_matches_pallas_interpret(torch, stem):
    """Plain stem == the unpadded Pallas stem kernel (interpret) at
    (1,8,56,56,3) × (7,7,7,3,16), atol 1e-4 (the bound of
    tests/test_pallas_ops.py:143-157)."""
    from crowded_scenes_ensemble_classification_tpu.ops.pallas.stem_conv import stem_conv_7x7x7_s2

    x, k, w = _stem_inputs(torch, (1, 8, 56, 56, 3), 16, seed=6)
    ref = np.asarray(stem_conv_7x7x7_s2(jnp.asarray(x), jnp.asarray(k), interpret=True))
    got = stem.stem_conv_7x7x7_s2_reference(torch.from_numpy(x), w).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_stem_wrapper_on_cpu_is_the_plain_version(torch, stem, tcommon):
    """A CPU tensor takes the plain version exactly and counts no launch;
    the s2d rewrite the kernel computes agrees to 1e-5 (another summation
    order), at an H ≠ W shape; odd T, H or W raise."""
    x, _, w = _stem_inputs(torch, (1, 6, 28, 36, 3), 16, seed=7)
    x = torch.from_numpy(x)
    before = stem.stem_conv_7x7x7_s2.launches
    got = stem.stem_conv_7x7x7_s2(x, w)
    assert stem.stem_conv_7x7x7_s2.launches == before
    assert torch.equal(got, stem.stem_conv_7x7x7_s2_reference(x, w))
    torch.testing.assert_close(tcommon.s2d_stem_conv(x, w), got, rtol=1e-5, atol=1e-5)
    for odd in ((1, 5, 28, 36, 3), (1, 6, 27, 36, 3), (1, 6, 28, 35, 3)):
        with pytest.raises(ValueError):
            stem.stem_conv_7x7x7_s2(torch.zeros(odd), w)


def _emulate_bf16_stem_kernel(torch, xs, wp, width, features):
    """The bf16 kernel's GEMM in plain f32 torch over exactly its inputs:
    per F-part and temporal tap inside [0, T), the A row of output (ho, wo)
    is, for dy = 0..3, the run of 4·C4 elements of staged row ho + dy that
    starts at element wo·C4 (so K is in (dy, dx, ch) order), times the
    part's packed weight rows without their pad.  It sums in float64, so
    the comparisons below measure the f32 rounding of the reference and of
    the Pallas kernel alone."""
    xs, wp = xs.double(), wp.double()
    n, t, h2, w2p, c4 = xs.shape
    parts, kd = wp.shape[0], 16 * c4
    to_, ho, wo = t // 2, h2 - 3, width // 2
    runs = xs.reshape(n, t, h2, w2p * c4).unfold(-1, 4 * c4, c4)[..., :wo, :]  # (n, t, h2, wo, 4·C4)
    y = torch.zeros(n, to_, ho, wo, parts * 32, dtype=torch.float64)
    for part in range(parts):
        for dt in range(7):
            w_dt = wp[part, dt, :, :kd]
            for o in range(to_):
                t_in = 2 * o - 2 + dt
                if 0 <= t_in < t:
                    a = torch.cat([runs[:, t_in, dy : dy + ho] for dy in range(4)], dim=-1)
                    y[:, o, ..., part * 32 : (part + 1) * 32] += a @ w_dt.T
    return y[..., :features].float()


@pytest.mark.parametrize(
    "x_shape,features",
    [
        ((1, 2, 28, 28, 3), 8),  # T=2: taps skipped at both ends; W/2 even, so W2 17 is padded to 18
        ((2, 4, 28, 30, 3), 40),  # W/2 odd: W2 18 already even; a second part of 8 channels
        ((1, 6, 28, 26, 3), 64),  # W/2 odd; two full parts
        ((1, 2, 56, 36, 2), 32),  # C=2 (4C = 8, the flow stream's width); one part
    ],
)
def test_bf16_kernel_layout_matches_reference_and_pallas(torch, stem, x_shape, features):
    """The staging and weight packing the bf16 kernel reads, run through a
    plain emulation of its GEMM, equal the plain stem and the Pallas v8
    kernel (interpret) to 1e-5 on f32 inputs.  The emulation and the plain
    stem sum in float64 (CPU conv3d's own f32 rounding reaches 1.3e-5 at
    F=64); the Pallas kernel sums in f32.  Staged rows are whole 16-byte chunks in bf16; packed
    rows carry zero pads and zero channels past F."""
    from crowded_scenes_ensemble_classification_tpu.ops.pallas.stem_conv_v8 import (
        stem_conv_7x7x7_s2_v8,
    )

    x, k, w = _stem_inputs(torch, x_shape, features, seed=8)
    n, t, h, width, c = x_shape
    xs = stem.s2d_stem_stage_even(torch.from_numpy(x))
    wp = stem.pack_stem_weights(w)
    w2p = xs.shape[3]
    assert xs.shape == (n, t, h // 2 + 3, w2p, 4 * c) and w2p % 2 == 0 and w2p - 3 - width // 2 in (0, 1)
    assert (w2p * 4 * c * 2) % 16 == 0
    assert torch.equal(xs[:, :, :, : width // 2 + 3], stem.s2d_stem_stage(torch.from_numpy(x)))
    parts = -(-features // 32)
    assert wp.shape == (parts, 7, 32, 64 * c + stem.WEIGHT_ROW_PAD) and wp.is_contiguous()
    assert not wp[..., 64 * c :].any()
    assert not wp.permute(1, 0, 2, 3).reshape(7, parts * 32, -1)[:, features:].any()
    got = _emulate_bf16_stem_kernel(torch, xs, wp, width, features).numpy()
    ref = stem.stem_conv_7x7x7_s2_reference(torch.from_numpy(x).double(), w.double()).float().numpy()
    assert got.shape == ref.shape == (n, t // 2, h // 2, width // 2, features)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    pallas = np.asarray(stem_conv_7x7x7_s2_v8(jnp.asarray(x), jnp.asarray(k), interpret=True))
    np.testing.assert_allclose(got, pallas, atol=1e-5)


# ----------------------------------------------------------------------
# salt/pepper
# ----------------------------------------------------------------------


@pytest.mark.parametrize(
    "counter,key,expect",
    [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        (
            (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
            (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1),
        ),
    ],
)
def test_philox_known_answers(torch, noise, counter, key, expect):
    """The plain Philox4x32-10 matches the Random123 known-answer vectors,
    so the CUDA kernel's generator has a fixed target."""
    words = noise.philox4x32_10(*[torch.tensor([c], dtype=torch.int64) for c in counter], *key)
    assert tuple(int(w) for w in words) == expect


def _pallas_noise_interpret(x, salt, pepper, ratio):
    from test_pallas_ops import _run  # the JAX package's own interpret runner

    return np.asarray(_run(jnp.asarray(x), 0, jnp.asarray(salt), jnp.asarray(pepper), ratio))


@pytest.mark.parametrize(
    "shape,salt,pepper,ratio",
    [
        ((3, 2, 16, 16, 1), [True, False, False], [False, True, False], 100),
        ((2, 5, 7, 7, 3), [True, True], [True, False], 10),  # 735: not a multiple of 4
    ],
)
def test_noise_reference_zero_bits_matches_pallas_interpret(torch, noise, shape, salt, pepper, ratio):
    """Interpret mode's generator returns all-zero bits; the plain version
    fed zero bits must give the same array, exactly."""
    x = np.random.default_rng(3).integers(1, 255, shape).astype(np.float32)
    kernel = _pallas_noise_interpret(x, np.array(salt), np.array(pepper), ratio)
    bits = torch.zeros(shape[0], int(np.prod(shape[1:])), dtype=torch.int64)
    got = noise.salt_pepper_reference(
        torch.from_numpy(x), bits, torch.tensor(salt), torch.tensor(pepper), ratio
    ).numpy()
    np.testing.assert_array_equal(got, kernel)


@pytest.mark.parametrize("shape", [(2, 4, 32, 32, 3), (2, 5, 7, 7, 3)])
def test_noise_gates_off_is_identity(torch, noise, shape):
    """Gates off: the wrapper returns the input unchanged, whatever the
    seed, at a length divisible by 4 and at one that is not."""
    x = torch.from_numpy(np.random.default_rng(4).integers(0, 255, shape).astype(np.float32))
    off = torch.zeros(shape[0], dtype=torch.bool)
    before = noise.salt_pepper.launches
    out = noise.salt_pepper(x, 987654321, off, off, 100)
    assert noise.salt_pepper.launches == before
    assert torch.equal(out, x)


def test_noise_gating_and_density(torch, noise):
    """Only gated clips change, only to 255 (salt) or 0 (pepper), each at a
    density in (0.005, 0.016) for ratio 100 (p = 655/65536 per element)."""
    x = torch.full((3, 4, 64, 64, 3), 128.0)
    on, off = torch.tensor([True, True, False]), torch.tensor([True, False, False])
    out = noise.salt_pepper(x, 2**40 + 17, on, off, 100)
    changed = out != 128.0
    assert not changed[2].any()
    assert set(torch.unique(out[changed]).tolist()) <= {0.0, 255.0}
    for clip in (out[0], out[1]):
        assert 0.005 < (clip == 255.0).float().mean().item() < 0.016
    assert 0.005 < (out[0] == 0.0).float().mean().item() < 0.016
    assert not (out[1] == 0.0).any()  # pepper gate off on clip 1


def test_noise_plain_is_deterministic_in_the_seed(torch, noise):
    """The same seed gives the same noise; another seed other noise."""
    x = torch.full((2, 3, 16, 16, 3), 128.0)
    on = torch.ones(2, dtype=torch.bool)
    a = noise.salt_pepper_plain(x, 5, on, on, 100)
    b = noise.salt_pepper_plain(x, 5, on, on, 100)
    c = noise.salt_pepper_plain(x, 6, on, on, 100)
    assert torch.equal(a, b) and not torch.equal(a, c)

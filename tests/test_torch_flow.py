"""Parity of the PyTorch port's dense optical flow (`flow/`) with the JAX
package's, on the CPU in float32.

The same numpy-seeded inputs go through the JAX functions (one pair,
vmapped) and the port's (a flat batch).  Flow is compared on textured
images: a periodic blur of seeded noise, moved by a known shift.  On flat
regions the 2×2 solve divides by a determinant clamped at 1e-6, so a
one-ulp difference in a correlation becomes pixels of flow; texture keeps
the solve well conditioned (the JAX tests blur noise into texture for the
same reason, tests/test_flow_motions.py:48-50).  The planes and the
displacement update are also compared on their own, where no iteration
amplifies a fault.  Each JAX solver is compiled once per schedule, through
module fixtures.  torch and the port are imported by fixtures, not at
collection (tests/torch_port_memory.py).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi

from crowded_scenes_ensemble_classification_tpu.flow import farneback as jfb
from crowded_scenes_ensemble_classification_tpu.flow import pyramid as jpyr
from crowded_scenes_ensemble_classification_tpu.flow import tvl1 as jtv
from torch_port_memory import release_heap_after_module, torch  # noqa: F401 (fixtures)

PORT = "crowded_scenes_ensemble_classification_tpu_torch"
SIZE = 64
SHIFT = (1, 2)  # (rows, columns): the true flow is u = 2, v = 1
MARGIN = 8  # the interior excludes the band the periodic shift wraps


@pytest.fixture(scope="module")
def port(torch):
    names = ("flow", "flow.pyramid", "flow.farneback", "flow.tvl1")
    return {n.split(".")[-1]: importlib.import_module(f"{PORT}.{n}") for n in names}


def textured(rng, n, h=SIZE, w=SIZE, shift=SHIFT):
    """n pairs of (h, w) 0-255 textures (a periodic Gaussian blur of noise,
    stretched) and the same textures moved by `shift`, each pair its own."""
    prevs, currs = [], []
    for _ in range(n):
        base = ndi.gaussian_filter(rng.random((h, w)) * 255.0, 2.0, mode="wrap")
        base = np.clip((base - base.mean()) * 4.0 + 128.0, 0.0, 255.0)
        prevs.append(base)
        currs.append(np.roll(base, shift, (0, 1)))
    return np.stack(prevs).astype(np.float32), np.stack(currs).astype(np.float32)


def interior(flow):
    return flow[:, MARGIN:-MARGIN, MARGIN:-MARGIN]


def jax_vmapped(fn, *arrays):
    return np.asarray(jax.vmap(fn)(*[jnp.asarray(a) for a in arrays]))


# ----------------------------------------------------------------------
# Constants and small functions
# ----------------------------------------------------------------------


def test_constants_match_jax(port):
    """The port's copies of the JAX constants and schedule helpers."""
    fb, tv, pyr = port["farneback"], port["tvl1"], port["pyramid"]
    assert fb.REFERENCE_PARAMS == jfb.REFERENCE_PARAMS
    assert fb.TURBO_PARAMS == jfb.TURBO_PARAMS
    assert tv.TVL1_TURBO_PARAMS == jtv.TVL1_TURBO_PARAMS
    assert (fb.FLOW_CHUNK_PAIRS, fb.FLOW_RESIZE_DIM) == (jfb.FLOW_CHUNK_PAIRS, jfb.FLOW_RESIZE_DIM)
    for hw in [(256, 256), (240, 320), (224, 224), (40, 40), (300, 199)]:
        assert fb.reference_flow_hw(hw) == jfb.reference_flow_hw(hw), hw
    for schedule in ("full", "turbo"):
        assert fb.flow_schedule_params(schedule) == jfb.flow_schedule_params(schedule)
    with pytest.raises(ValueError, match="unknown flow schedule"):
        fb.flow_schedule_params("fast")
    (k, kj), (g, gj) = zip(fb._poly_exp_setup(5, 1.1), jfb._poly_exp_setup(5, 1.1))
    assert all(np.array_equal(a, b) for a, b in zip(k, kj)) and np.array_equal(g, gj)
    np.testing.assert_array_equal(pyr.box_kernel(11), jpyr.box_kernel(11))
    np.testing.assert_array_equal(pyr.gaussian_kernel(1.1), jpyr.gaussian_kernel(1.1))
    assert sorted(n for n in dir(port["flow"]) if not n.startswith("_") and n not in (
        "farneback", "pyramid", "tvl1")) == sorted(n for n in dir(importlib.import_module(
            "crowded_scenes_ensemble_classification_tpu.flow")) if not n.startswith("_") and n not in (
            "farneback", "pyramid", "tvl1"))


@pytest.mark.parametrize("multi", [False, True], ids=["single", "depthwise"])
def test_sep_conv2d_matches_jax(torch, port, multi):
    """Edge-replicated separable correlations of 0-255 images at an odd
    size, atol 1e-4 (a few ulps of 255: XLA's CPU convolution sums the taps
    in another order than the port's one-after-another sum)."""
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (3, 37, 29)).astype(np.float32)
    pyr = port["pyramid"]
    if multi:
        (g, xg, x2g), _ = jfb._poly_exp_setup(5, 1.1)
        box = jpyr.box_kernel(11)
        ky = np.stack([g, xg, x2g, g])
        kx = np.stack([box, box, jpyr.gaussian_kernel(1.1, 5), box])
        x = rng.uniform(0, 255, (2, 37, 29, 4)).astype(np.float32)
        ref = jax_vmapped(lambda a: jpyr._sep_conv2d_multi(a, ky, kx), x)
        got = pyr._sep_conv2d_multi(torch.from_numpy(x).permute(0, 3, 1, 2), ky, kx).permute(0, 2, 3, 1).numpy()
    else:
        ky = jpyr.gaussian_kernel(1.1)
        kx = jpyr.box_kernel(11)
        ref = jax_vmapped(lambda a: jpyr._sep_conv2d(a, ky, kx), img)
        got = pyr._sep_conv2d(torch.from_numpy(img), ky, kx).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("hw", [(64, 64), (70, 45), (37, 29)])
def test_pyramid_matches_jax(torch, port, hw):
    """pyr_down keeps the ceiling on odd sizes, build_pyramid stops at
    min_size=16 (4 levels for 224², here 3, 2 and 1), and each level agrees
    with JAX at atol 1e-4 on 0-255 images (summation order, as above)."""
    img = np.random.default_rng(2).uniform(0, 255, (2,) + hw).astype(np.float32)
    ref = [np.asarray(r) for r in jax.jit(jax.vmap(lambda a: jpyr.build_pyramid(a, 5)))(img)]
    got = port["pyramid"].build_pyramid(torch.from_numpy(img), 5)
    assert [g.shape[1:] for g in got] == [r.shape[1:] for r in ref]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-4)
    assert [tuple(x.shape) for x in port["pyramid"].build_pyramid(torch.zeros(1, 224, 224), 5)] == [
        (1, 224, 224), (1, 112, 112), (1, 56, 56), (1, 28, 28)]


@pytest.mark.parametrize("hw,out_hw", [((8, 10), (16, 20)), ((15, 15), (29, 29)), ((14, 13), (28, 25)),
                                       ((7, 9), (7, 17)), ((10, 10), (7, 9))])
def test_upsample_flow_matches_jax(torch, port, hw, out_hw):
    """jax.image.resize(..., "linear") with the displacements rescaled, at
    ×2, at the odd ratios truncated pyramids give (15 → 29), with one axis
    kept, and downscaled (antialiased): atol 1e-5 on flows of a few px."""
    f = np.random.default_rng(3).normal(0, 3, (2,) + hw + (2,)).astype(np.float32)
    ref = jax_vmapped(lambda a: jpyr.upsample_flow(a, out_hw), f)
    got = port["pyramid"].upsample_flow(torch.from_numpy(f), out_hw).numpy()
    assert got.shape == ref.shape == (2,) + out_hw + (2,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_image_gradients_match_jax(torch, port):
    img = np.random.default_rng(4).uniform(0, 255, (2, 21, 17)).astype(np.float32)
    ref = jax_vmapped(lambda a: jnp.stack(jpyr.image_gradients(a)), img)
    got = torch.stack(port["pyramid"].image_gradients(torch.from_numpy(img)), 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def warp_fields(rng, n, h, w, max_disp):
    """Displacements beyond ±max_disp, integer-valued ones, and ones that
    leave the image."""
    f = rng.normal(0, max_disp / 2, (n, h, w, 2)).astype(np.float32)
    f[0, :4] = 3.0 * max_disp  # beyond the clamp
    f[0, 4:8, :, 0] = -(w + 5.0)  # off the image to the left
    f[1] = np.round(f[1])  # integer-valued
    f[1, :3, :, 1] = max_disp  # exactly the clamp
    return f


@pytest.mark.parametrize("max_disp", [4, 16])
@pytest.mark.parametrize("warp", ["mxu", "separable", "gather"])
def test_warps_match_jax(torch, port, warp, max_disp):
    """The exact warp (a 4-tap gather) against `warp_image_mxu`, the
    separable one (2 taps per axis) against `warp_image_separable`, both on
    a channel-packed (N, 3, H, W) stack, and `warp_image` on (N, H, W):
    atol 2e-4 on 0-255 images, 3e-4 for the MXU form, whose one-hot matmul
    rounds away from JAX's own gather warp by up to 2.3e-4 on these inputs
    (it claims 2e-4, JAX pyramid.py:157-160).  The exact warp also equals
    JAX's gather warp on the clamped field, bit for bit."""
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 255, (3, 3, 28, 23)).astype(np.float32)
    f = warp_fields(rng, 3, 28, 23, max_disp)
    pyr = port["pyramid"]
    if warp == "gather":
        ref = jax_vmapped(jpyr.warp_image, img[:, 0], f)
        got = pyr.warp_image(torch.from_numpy(img[:, 0]), torch.from_numpy(f)).numpy()
    else:
        jfn = {"mxu": lambda a, b: jpyr.warp_image_mxu(a, b, max_disp=max_disp),
               "separable": lambda a, b: jpyr.warp_image_separable(a, b, max_disp=max_disp)}[warp]
        tfn = {"mxu": pyr.warp_image_mxu, "separable": pyr.warp_image_separable}[warp]
        ref = jax_vmapped(jfn, img, f)
        got = tfn(torch.from_numpy(img), torch.from_numpy(f), max_disp=max_disp).numpy()
        single = tfn(torch.from_numpy(img[:, 1]), torch.from_numpy(f), max_disp=max_disp).numpy()
        np.testing.assert_array_equal(single, got[:, 1])
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=3e-4 if warp == "mxu" else 2e-4)
    if warp == "mxu":
        clamped = jax_vmapped(jpyr.warp_image, img[:, 0], np.clip(f, -max_disp, max_disp))
        np.testing.assert_array_equal(got[:, 0], clamped)


def test_rgb_to_gray_matches_jax(torch, port):
    """BGR order, Rec.601 weights, on uint8 and float32 clips."""
    x = np.random.default_rng(6).integers(0, 256, (2, 3, 8, 9, 3)).astype(np.uint8)
    for a in (x, x.astype(np.float32)):
        ref = np.asarray(jfb.rgb_to_gray(jnp.asarray(a)))
        got = port["farneback"].rgb_to_gray(torch.from_numpy(a))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-4)


def test_quantize_flow_matches_jax_exactly(torch, port):
    """py-denseflow's uint8 flow: quantize and dequantize equal JAX's
    exactly, ties rounded to even, both sides of the clip bound."""
    f = np.random.default_rng(7).normal(0, 15, (2, 9, 11, 2)).astype(np.float32)
    f[0, 0, :4, 0] = [-20.0, 20.0, 0.0, 20.0 / 255.0]
    tv = port["tvl1"]
    q = tv.quantize_flow_u8(torch.from_numpy(f), 20.0)
    qj = np.asarray(jtv.quantize_flow_u8(jnp.asarray(f), 20.0))
    assert q.dtype == torch.uint8
    np.testing.assert_array_equal(q.numpy(), qj)
    np.testing.assert_array_equal(tv.dequantize_flow_u8(q, 20.0).numpy(),
                                  np.asarray(jtv.dequantize_flow_u8(jnp.asarray(qj), 20.0)))


# ----------------------------------------------------------------------
# Farnebäck: the planes, one update, and whole schedules
# ----------------------------------------------------------------------


def test_polynomial_planes_match_jax(torch, port):
    """The five planes (axx, ayy, axy, bx, by) and the packed (A, b) API,
    each within 1e-5 of its largest magnitude: the moments agree to about
    1e-7, and the 6×6 solve cancels the large moments of 0-255 images into
    the small second-order coefficients."""
    fb = port["farneback"]
    img, _ = textured(np.random.default_rng(8), 2)
    kernels, ginv = jfb._poly_exp_setup(5, 1.1)
    ref = jax_vmapped(lambda a: jnp.stack(jfb._poly_exp_planes(a, kernels, ginv)), img)
    got = torch.stack(fb._poly_exp_planes(torch.from_numpy(img), kernels, ginv), 1).numpy()
    for i, name in enumerate(("axx", "ayy", "axy", "bx", "by")):
        scale = np.abs(ref[:, i]).max()
        assert np.abs(got[:, i] - ref[:, i]).max() <= 1e-5 * scale, name
    A, b = fb.polynomial_expansion(torch.from_numpy(img), kernels, ginv)
    Aj, bj = jax.vmap(lambda a: jfb.polynomial_expansion(a, kernels, ginv))(jnp.asarray(img))
    assert A.shape == Aj.shape and b.shape == bj.shape
    np.testing.assert_allclose(A.numpy(), np.asarray(Aj), rtol=0, atol=1e-5 * np.abs(np.asarray(Aj)).max())
    np.testing.assert_allclose(b.numpy(), np.asarray(bj), rtol=0, atol=1e-5 * np.abs(np.asarray(bj)).max())


def test_displacement_update_matches_jax(torch, port):
    """One displacement solve from the JAX planes of a textured pair and a
    seeded flow: within 1e-5 of its largest magnitude where the windowed
    determinant is well above the eps clamp (1e-3 of its median), and the
    clamp itself exercised on a flat image."""
    fb = port["farneback"]
    prev, curr = textured(np.random.default_rng(9), 2)
    flow = np.random.default_rng(10).normal(0, 1, prev.shape + (2,)).astype(np.float32)
    kernels, ginv = jfb._poly_exp_setup(5, 1.1)
    win = jfb.box_kernel(11)

    planes = jax.jit(jax.vmap(lambda x: jnp.stack(jfb._poly_exp_planes(x, kernels, ginv))))
    update = jax.jit(jax.vmap(lambda a, b, f: jfb._displacement_update_planes(tuple(a), tuple(b), f, win)))
    p1, p2 = planes(prev), planes(curr)
    ref = np.asarray(update(p1, p2, jnp.asarray(flow)))
    t = lambda a: tuple(torch.from_numpy(np.array(a)).unbind(1))  # noqa: E731
    got = fb._displacement_update_planes(t(p1), t(p2), torch.from_numpy(flow), win).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    flat = np.full((1, 24, 24), 100.0, np.float32)
    pf = planes(flat)
    ref = np.asarray(update(pf, pf, jnp.asarray(flow[:1, :24, :24])))
    got = fb._displacement_update_planes(t(pf), t(pf), torch.from_numpy(flow[:1, :24, :24]), win).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * max(1.0, np.abs(ref).max()))


# max_disp=4 clamps nothing of a 2 px motion and keeps the JAX compile of
# the 2·max_disp+1 shifted copies small; the warp tests hold the clamp.
SCHEDULES = {
    "full_exact": dict(max_disp=4),
    "full_fast_warp": dict(fast_warp=True, max_disp=4),
    "turbo": dict(jfb.TURBO_PARAMS, max_disp=4),
}


@pytest.fixture(scope="module")
def flow_pairs():
    return textured(np.random.default_rng(11), 2)


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_farneback_pair_matches_jax(torch, port, flow_pairs, schedule):
    """farneback_flow_pair on 2 textured 64² pairs (3 pyramid levels), a
    (1, 2) shift: within 1e-3 px of JAX on the interior, and the EPE there
    within the JAX suite's ceiling for translation (0.05 px,
    tests/test_flow_motions.py:88)."""
    kw = SCHEDULES[schedule]
    prev, curr = flow_pairs
    ref = jax_vmapped(lambda a, b: jfb.farneback_flow_pair(a, b, **kw), prev, curr)
    got = port["farneback"].farneback_flow_pair(torch.from_numpy(prev), torch.from_numpy(curr), **kw).numpy()
    assert got.shape == ref.shape == prev.shape + (2,)
    assert np.abs(interior(got) - interior(ref)).max() <= 1e-3
    epe = np.sqrt(((interior(got) - np.float32([SHIFT[1], SHIFT[0]])) ** 2).sum(-1)).mean()
    assert epe <= 0.05, epe
    one = port["farneback"].farneback_flow_pair(torch.from_numpy(prev[1]), torch.from_numpy(curr[1]), **kw)
    assert torch.equal(one, torch.from_numpy(got[1]))


def test_farneback_batch_chunks_do_not_change_a_pair(torch, port):
    """farneback_flow_batch over (2, 3) leading dims: chunks of 4 pairs (a
    ragged last chunk) equal the unchunked batch exactly, every pair
    equals farneback_flow_pair alone, and the clip form pairs frames t and
    t+1."""
    fb = port["farneback"]
    prev, curr = textured(np.random.default_rng(12), 6, 32, 40)
    p, c = torch.from_numpy(prev).reshape(2, 3, 32, 40), torch.from_numpy(curr).reshape(2, 3, 32, 40)
    whole = fb.farneback_flow_batch(p, c, **fb.TURBO_PARAMS)
    chunked = fb.farneback_flow_batch(p, c, chunk_pairs=4, **fb.TURBO_PARAMS)
    assert whole.shape == (2, 3, 32, 40, 2)
    assert torch.equal(whole, chunked)
    alone = fb.farneback_flow_pair(torch.from_numpy(prev[4:5]), torch.from_numpy(curr[4:5]), **fb.TURBO_PARAMS)
    assert torch.equal(alone[0], whole[1, 1])
    clip = torch.from_numpy(np.stack([prev[0], curr[0], prev[0]]))
    flows = fb.farneback_flow_clip(clip, **fb.TURBO_PARAMS)
    assert flows.shape == (2, 32, 40, 2) and torch.equal(flows[0], whole[0, 0])


# ----------------------------------------------------------------------
# TV-L1
# ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tvl1_pair_matches_jax(torch, port, flow_pairs, dtype):
    """tvl1_flow_pair (2 levels, 2 warps, 10 dual steps) on the textured
    pairs, one with its intensities scaled and offset (the joint rescale is
    per pair): f32 within 1e-3 px of JAX on the interior; bf16 duals within
    0.05 px on average and 0.5 px at most (bf16 rounds at other places in
    the two frameworks, and the dual loop carries it)."""
    prev, curr = flow_pairs
    prev, curr = prev.copy(), curr.copy()
    prev[1], curr[1] = prev[1] * 0.3 + 40.0, curr[1] * 0.3 + 40.0
    kw = dict(levels=2, warps=2, inner_iters=10, max_disp=4)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax_vmapped(lambda a, b: jtv.tvl1_flow_pair(a, b, compute_dtype=jdt, **kw), prev, curr)
    got = port["tvl1"].tvl1_flow_pair(torch.from_numpy(prev), torch.from_numpy(curr), compute_dtype=tdt, **kw)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    d = np.abs(interior(got.numpy()) - interior(ref))
    if dtype == "float32":
        assert d.max() <= 1e-3, d.max()
    else:
        assert d.mean() <= 0.05 and d.max() <= 0.5, (d.mean(), d.max())
    clip = torch.from_numpy(np.stack([prev[0], curr[0]]))
    np.testing.assert_array_equal(port["tvl1"].tvl1_flow_clip(clip, compute_dtype=tdt, **kw)[0].numpy(),
                                  got[0].numpy())


def test_forward_grad_and_divergence_match_jax(torch, port):
    """Neumann forward differences and their adjoint divergence, exactly."""
    rng = np.random.default_rng(13)
    x, y = rng.normal(size=(2, 2, 9, 7)).astype(np.float32)
    tv = port["tvl1"]
    ref = jax_vmapped(lambda a: jnp.stack(jtv._forward_grad(a)), x)
    np.testing.assert_array_equal(torch.stack(tv._forward_grad(torch.from_numpy(x)), 1).numpy(), ref)
    ref = jax_vmapped(jtv._divergence, x, y)
    np.testing.assert_array_equal(tv._divergence(torch.from_numpy(x), torch.from_numpy(y)).numpy(), ref)

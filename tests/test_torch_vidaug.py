"""The port's vidaug op library against the JAX package's on the CPU.

Each op's deterministic core is fed the parameters and noise that the JAX
random variant draws from its key (read back with the same key splits),
and held against that variant: bilinear ops within 1e-4 of 255 (float32
coordinates and lerps, fused differently), blurs within 1e-4 of 255, and
integer ops (flips, crops, gathers, frame indices, hit masks) exactly.  The
combinators are held with forced choices: the port's, replayed from the
generator, against JAX's ops composed in that order, and JAX's, read from
its key, against the port's ops composed in its order.  Small clips
(3 frames at 12×16, 2 channels); torch and the port are imported by
fixtures (tests/torch_port_memory.py).
"""

import importlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crowded_scenes_ensemble_classification_tpu.ops import affine as jaffine
from crowded_scenes_ensemble_classification_tpu.ops import crop_flip as jcrop
from crowded_scenes_ensemble_classification_tpu.ops import geometric as jgeo
from crowded_scenes_ensemble_classification_tpu.ops import group as jgroup
from crowded_scenes_ensemble_classification_tpu.ops import intensity as jint
from crowded_scenes_ensemble_classification_tpu.ops import temporal as jtemp
from torch_port_memory import release_heap_after_module, torch  # noqa: F401 (fixtures)

BILINEAR_ATOL = 1e-4 * 255
SHAPE = (3, 12, 16, 2)


@pytest.fixture(scope="module")
def ops(torch):
    return {name: importlib.import_module(f"crowded_scenes_ensemble_classification_tpu_torch.ops.{name}")
            for name in ("intensity", "crop_flip", "affine", "geometric", "temporal", "group")}


def _clip(seed=0, shape=SHAPE):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.float32)


def _t(torch, a):
    return torch.from_numpy(np.array(a))


def test_intensity_matches_jax(torch, ops):
    it = ops["intensity"]
    clip = _clip(1)
    x = _t(torch, clip)
    key = jax.random.key(3)
    ref = jax.jit(lambda c, k: (jint.invert_color(c), jint.add(c, 40.5), jint.add(c, -300), jint.multiply(c, 1.7),
                                jax.random.randint(k, c.shape, 0, 7) == 0, jint.pepper(c, k, 7), jint.salt(c, k, 7)))(
        clip, key)
    for port, r in zip((it.invert_color(x), it.add(x, 40.5), it.add(x, -300), it.multiply(x, 1.7)), ref):
        np.testing.assert_array_equal(port.numpy(), np.asarray(r))
    hits = _t(torch, ref[4])
    np.testing.assert_array_equal(it.pepper_hits(x, hits).numpy(), np.asarray(ref[5]))
    np.testing.assert_array_equal(it.salt_hits(x, hits).numpy(), np.asarray(ref[6]))
    g = torch.Generator().manual_seed(0)
    big = torch.full((40, 50, 50), 100.0)
    assert 0.008 < (it.salt(big, g) == 255).float().mean() < 0.012
    assert 0.008 < (it.pepper(big, g) == 0).float().mean() < 0.012


@pytest.mark.parametrize("size", [(8, 10), (7, 9), (12, 16)])
def test_crops_and_flips_match_jax(torch, ops, size):
    cf = ops["crop_flip"]
    clip = _clip(2)
    x = _t(torch, clip)
    np.testing.assert_array_equal(cf.horizontal_flip(x).numpy(), np.asarray(jcrop.horizontal_flip(clip)))
    np.testing.assert_array_equal(cf.vertical_flip(x).numpy(), np.asarray(jcrop.vertical_flip(clip)))
    np.testing.assert_array_equal(cf.center_crop(x, size).numpy(), np.asarray(jcrop.center_crop(clip, size)))
    for pos in cf.CORNER_POSITIONS:
        np.testing.assert_array_equal(cf.corner_crop(x, size, pos).numpy(),
                                      np.asarray(jcrop.corner_crop(clip, size, pos)))
    for seed in range(3):
        key = jax.random.key(seed)
        pos = cf.CORNER_POSITIONS[int(jax.random.randint(key, (), 0, 5))]
        np.testing.assert_array_equal(cf.corner_crop(x, size, pos).numpy(),
                                      np.asarray(jcrop.corner_crop(clip, size, key=key)))
        ky, kx = jax.random.split(key)
        y0 = int(jax.random.randint(ky, (), 0, 12 - size[0] + 1))
        x0 = int(jax.random.randint(kx, (), 0, 16 - size[1] + 1))
        np.testing.assert_array_equal(cf.crop_at(x, y0, x0, size).numpy(),
                                      np.asarray(jcrop.random_crop(clip, size, key)))
    g = torch.Generator().manual_seed(1)
    assert cf.random_crop(x, size, g).shape == (3,) + tuple(size) + (2,)
    assert cf.corner_crop(x, size, generator=g).shape == (3,) + tuple(size) + (2,)
    with pytest.raises(ValueError):
        cf.center_crop(x, (13, 4))


AFFINE_M = [[0.9, 0.1, 1.5], [-0.2, 1.1, -0.75]]


@pytest.fixture(scope="module")
def j_affine():
    """JAX's affine ops on one key, jitted once (eager JAX compiles op by op)."""
    return jax.jit(lambda c, k: {
        "rotate": jaffine.random_rotate(c, k, (-30.0, 30.0)),
        "translate": jaffine.random_translate(c, k, 3, 2),
        "translate_frac": jaffine.translate(c, 1.25, -0.5),
        "shear": jaffine.random_shear(c, k, 0.3, 0.2),
        "scale": jaffine.random_resize(c, k, 0.2),
        "warp": jaffine.warp_affine_inverse(c, AFFINE_M, (10, 14), 7.0),
    })


@pytest.fixture(scope="module")
def j_sample():
    return jax.jit(lambda c, y, x: jaffine.sample_bilinear(c, y, x, 3.0))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_affine_matches_jax(torch, ops, j_affine, j_sample, seed):
    """rotate, translate, shear and scale (the random variants' parameters
    read from JAX's keys), the generic inverse warp and the sampler."""
    af = ops["affine"]
    clip = _clip(10 + seed)
    x = _t(torch, clip)
    key = jax.random.key(seed)
    close = lambda p, r: np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=BILINEAR_ATOL)  # noqa: E731
    ref = j_affine(clip, key)
    angle = float(jax.random.uniform(key, (), minval=-30.0, maxval=30.0))
    close(af.rotate(x, angle), ref["rotate"])
    kx, ky = jax.random.split(key)
    xm, ym = int(jax.random.randint(kx, (), -3, 4)), int(jax.random.randint(ky, (), -2, 3))
    close(af.translate(x, float(xm), float(ym)), ref["translate"])
    close(af.translate(x, 1.25, -0.5), ref["translate_frac"])
    sx = float(jax.random.uniform(kx, (), minval=-0.3, maxval=0.3))
    sy = float(jax.random.uniform(ky, (), minval=-0.2, maxval=0.2))
    close(af.shear(x, sx, sy), ref["shear"])
    factor = float(jax.random.uniform(key, (), minval=0.8, maxval=1.2))
    close(af.scale(x, factor), ref["scale"])
    close(af.warp_affine_inverse(x, AFFINE_M, (10, 14), fill=7.0), ref["warp"])
    rng = np.random.default_rng(seed)
    sy_, sx_ = (rng.uniform(-2, 14, (5, 6)).astype(np.float32), rng.uniform(-2, 18, (5, 6)).astype(np.float32))
    close(af.sample_bilinear(x, _t(torch, sy_), _t(torch, sx_), 3.0), j_sample(clip, sy_, sx_))
    g = torch.Generator().manual_seed(seed)
    for out in (af.random_rotate(x, g, (-10, 10)), af.random_translate(x, g, 2, 2), af.random_shear(x, g, 0.1, 0.1),
                af.random_resize(x, g, 0.1)):
        assert out.shape == x.shape and torch.isfinite(out).all()


@pytest.mark.parametrize("sigma,blur_channels", [(0.8, False), (1.5, True), (0.0, False)])
def test_gaussian_blur_matches_jax(torch, ops, sigma, blur_channels):
    clip = _clip(4)
    got = ops["geometric"].gaussian_blur(_t(torch, clip), sigma, blur_channels)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgeo.gaussian_blur(clip, sigma, blur_channels)),
                               atol=BILINEAR_ATOL)


@pytest.mark.parametrize("alpha,sigma", [(3.0, 1.0), (2.0, 0.0)])
def test_elastic_matches_jax(torch, ops, alpha, sigma):
    """The per-frame fields from JAX's own uniform draws (split T, then
    split 2 per frame)."""
    clip = _clip(5)
    key = jax.random.key(7)
    u = [[np.asarray(jax.random.uniform(k2, SHAPE[1:3], minval=-1.0, maxval=1.0)) for k2 in jax.random.split(k)]
         for k in jax.random.split(key, SHAPE[0])]
    u_y, u_x = (_t(torch, np.stack([f[i] for f in u])) for i in (0, 1))
    got = ops["geometric"].elastic_from_noise(_t(torch, clip), u_y, u_x, alpha, sigma, cval=9.0)
    ref = jax.jit(lambda c, k: jgeo.elastic_transformation(c, k, alpha, sigma, cval=9.0))(clip, key)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=BILINEAR_ATOL)
    g = torch.Generator().manual_seed(0)
    assert ops["geometric"].elastic_transformation(_t(torch, clip), g, alpha, sigma).shape == clip.shape


@pytest.mark.parametrize("seed", [0, 1])
def test_piecewise_affine_matches_jax(torch, ops, seed):
    """Integer displacement maps from JAX's noise: the gather is exact."""
    clip = _clip(6)
    key = jax.random.key(seed)
    u = [_t(torch, jax.random.uniform(k, SHAPE[1:3], minval=-4.0, maxval=4.0)) for k in jax.random.split(key)]
    got = ops["geometric"].piecewise_affine_from_noise(_t(torch, clip), u[0], u[1], 1.5, 1.2)
    ref = jax.jit(lambda c, k: jgeo.piecewise_affine_transform(c, k, 4.0, 1.5, 1.2))(clip, key)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    g = torch.Generator().manual_seed(seed)
    assert ops["geometric"].piecewise_affine_transform(_t(torch, clip), g, 4.0, 1.5, 1.2).shape == clip.shape


def test_superpixels_match_jax(torch, ops):
    """The segment means by index_add_ against JAX's segment_sum, with
    JAX's replacement draws; SLIC needs skimage on the host."""
    geo = ops["geometric"]
    clip = _clip(8)
    segments = np.random.default_rng(0).integers(0, 9, SHAPE[1:3]).astype(np.int32)
    segments[0, 0] = 8
    key = jax.random.key(2)
    replace = np.asarray(jax.random.bernoulli(key, 0.5, (9,)))
    got = geo.apply_superpixels_from_choice(_t(torch, clip), _t(torch, segments), _t(torch, replace))
    np.testing.assert_allclose(got.numpy(), np.asarray(jgeo.apply_superpixels(clip, segments, 0.5, key)),
                               atol=BILINEAR_ATOL)
    g = torch.Generator().manual_seed(0)
    assert geo.apply_superpixels(_t(torch, clip), _t(torch, segments), 0.5, g).shape == clip.shape
    try:
        import skimage  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            geo.superpixel_segments_host(clip.mean(0), 8)
    else:
        np.testing.assert_array_equal(geo.superpixel_segments_host(clip.mean(0), 8),
                                      jgeo.superpixel_segments_host(clip.mean(0), 8))


@pytest.mark.parametrize("frames", [5, 21])
def test_temporal_matches_jax(torch, ops, frames):
    tp = ops["temporal"]
    clip = _clip(9, (frames, 2, 3, 1))
    x = _t(torch, clip)
    eq = lambda p, r: np.testing.assert_array_equal(p.numpy(), np.asarray(r))  # noqa: E731
    sizes, keys = (4, 8, 16), [jax.random.key(seed) for seed in range(6)]

    @jax.jit
    def ref(c, ks):
        """Every JAX op of the test on this clip, in one compile."""
        fixed = [(jtemp.select_frames(c, n), jtemp.temporal_begin_crop(c, n), jtemp.temporal_center_crop(c, n),
                  jtemp.temporal_fit(c, n), [jtemp.temporal_random_crop(c, n, k) for k in ks[:2]]) for n in sizes]
        return (fixed, jtemp.inverse_order(c), jtemp.downsample(c, 0.5), jtemp.upsample(c, 1.5),
                [jtemp.temporal_elastic_transformation(c, k) for k in ks])

    fixed, inverse, down, up, elastic = ref(clip, keys)
    for size, (sel, begin_crop, center, fit, random_crops) in zip(sizes, fixed):
        eq(tp.select_frames(x, size), sel)
        eq(tp.temporal_begin_crop(x, size), begin_crop)
        eq(tp.temporal_center_crop(x, size), center)
        eq(tp.temporal_fit(x, size), fit)
        for key, out in zip(keys, random_crops):
            begin = int(jax.random.randint(key, (), 0, max(0, frames - size - 1) + 1))
            eq(tp.temporal_crop_at(x, size, begin), out)
    eq(tp.inverse_order(x), inverse)
    eq(tp.downsample(x, 0.5), down)
    eq(tp.upsample(x, 1.5), up)
    for key, out in zip(keys, elastic):
        k_inv, k_scale = jax.random.split(key)
        idx = tp.temporal_elastic_indices(frames, bool(jax.random.bernoulli(k_inv)),
                                          float(jax.random.uniform(k_scale, ())))
        eq(x.index_select(0, idx), out)
    g = torch.Generator().manual_seed(0)
    assert tp.temporal_random_crop(x, 4, g).shape[0] == 4
    assert tp.temporal_elastic_transformation(x, g).shape == x.shape


def _pairs(torch, ops):
    """Deterministic transforms, (port, jax) pairs taking (clip, generator/key)."""
    it, cf = ops["intensity"], ops["crop_flip"]
    return [
        (lambda c, g: it.add(c, 10.0), lambda c, k: jint.add(c, 10.0)),
        (lambda c, g: it.multiply(c, 0.5), lambda c, k: jint.multiply(c, 0.5)),
        (lambda c, g: it.invert_color(c), lambda c, k: jint.invert_color(c)),
        (lambda c, g: cf.horizontal_flip(c), lambda c, k: jcrop.horizontal_flip(c)),
    ]


def _compose(fns, order, clip, rng):
    for i in order:
        clip = fns[i](clip, rng)
    return clip


@pytest.fixture(scope="module")
def j_combinators(torch, ops):
    """JAX's combinators over the JAX side of `_pairs`, each jitted once."""
    fns = [j for _, j in _pairs(torch, ops)]
    return {
        "sequential": jax.jit(jgroup.sequential(fns)),
        "random_order": jax.jit(jgroup.sequential(fns, random_order=True)),
        "one_of": jax.jit(jgroup.one_of(fns)),
        True: jax.jit(jgroup.some_of(fns, 2, True)),
        False: jax.jit(jgroup.some_of(fns, 2, False)),
        "sometimes": jax.jit(jgroup.sometimes(0.5, fns[0])),
    }


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_combinators_with_forced_choices(torch, ops, j_combinators, seed):
    """Each combinator's choice, replayed from a generator of the same seed
    (the port) or read from the key's splits (JAX): the port's result equals
    JAX's ops composed in the port's order, and JAX's result equals the
    port's ops composed in JAX's order."""
    gr = ops["group"]
    pairs = _pairs(torch, ops)
    port_fns, jax_fns = [p for p, _ in pairs], [j for _, j in pairs]
    clip = _clip(20 + seed)
    x = _t(torch, clip)
    gen = lambda: torch.Generator().manual_seed(seed)  # noqa: E731
    key = jax.random.key(seed)
    k_pick = jax.random.split(key)[0]
    n = len(pairs)

    def check(port_out, port_order, jax_out, jax_order):
        want = _compose(jax_fns, port_order, jnp.asarray(clip), key)
        np.testing.assert_array_equal(port_out.numpy(), np.asarray(want))
        np.testing.assert_array_equal(np.asarray(jax_out), _compose(port_fns, jax_order, x, None).numpy())

    check(gr.sequential(port_fns)(x, gen()), range(n), j_combinators["sequential"](clip, key), range(n))
    perms = list(itertools.permutations(range(n)))
    check(gr.sequential(port_fns, random_order=True)(x, gen()), torch.randperm(n, generator=gen()).tolist(),
          j_combinators["random_order"](clip, key),
          perms[int(jax.random.randint(k_pick, (), 0, len(perms)))])
    check(gr.one_of(port_fns)(x, gen()), [int(torch.randint(0, n, (), generator=gen()))],
          j_combinators["one_of"](clip, key), [int(jax.random.randint(k_pick, (), 0, n))])
    subsets = list(itertools.combinations(range(n), 2))
    for random_order in (True, False):
        pick = torch.randperm(n, generator=gen())[:2].tolist()
        check(gr.some_of(port_fns, 2, random_order)(x, gen()), pick if random_order else sorted(pick),
              j_combinators[random_order](clip, key),
              subsets[int(jax.random.randint(k_pick, (), 0, len(subsets)))])
    gate = float(torch.rand((), generator=gen())) < 0.5
    check(gr.sometimes(0.5, port_fns[0])(x, gen()), [0] if gate else [],
          j_combinators["sometimes"](clip, key), [0] if bool(jax.random.bernoulli(k_pick, 0.5)) else [])
    with pytest.raises(ValueError):
        gr.some_of(port_fns, 5)

"""The port's main-path data ops against the JAX package on the CPU:
I420 decode, bilinear crop/resize with the JAX key splits' own decisions,
and the augment's decision draws.  torch and the port are imported by
fixtures, not at collection (tests/torch_port_memory.py)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crowded_scenes_ensemble_classification_tpu.data.wire_format import i420_to_bgr_u8 as j_i420
from crowded_scenes_ensemble_classification_tpu.ops import augment as jaugment
from torch_port_memory import release_heap_after_module, torch  # noqa: F401 (fixtures)


@pytest.fixture(scope="module")
def augment(torch):
    return importlib.import_module("crowded_scenes_ensemble_classification_tpu_torch.ops.augment")


@pytest.mark.parametrize("frames,h,w", [(3, 16, 24), (2, 32, 32)])
def test_i420_to_bgr_bit_exact(torch, frames, h, w):
    """Bit-exact: the same float32 arithmetic, both sides rounding half to
    even.  A leading batch axis decodes clip by clip."""
    from crowded_scenes_ensemble_classification_tpu_torch.data.wire_format import i420_to_bgr_u8

    rows = np.random.default_rng(0).integers(0, 256, (2, frames * h * w * 3 // 2), dtype=np.uint8)
    ref = np.asarray(jax.vmap(lambda f: j_i420(f, frames, h, w))(rows))
    got = i420_to_bgr_u8(torch.from_numpy(rows), frames, h, w).numpy()
    assert got.dtype == np.uint8 and got.shape == (2, frames, h, w, 3)
    np.testing.assert_array_equal(got, ref)


def _jax_decisions(key, batch, staging_hw, p):
    """Crop decisions from the JAX package's host replica and flips from the
    same split(…, 7) per clip key, as numpy."""
    do_crop, y0, x0 = jaugment.augment_crop_decisions(key, batch, staging_hw, p)
    flip = [bool(jax.random.bernoulli(jax.random.split(k, 7)[2], p))
            for k in jax.random.split(key, batch)]
    return do_crop, y0, x0, np.array(flip)


@pytest.mark.parametrize("seed", [0, 1])
def test_crop_resize_matches_jax_augment(torch, augment, seed):
    """crowd11_augment_from_decisions with the noise gates off == vmapped JAX
    crowd11_augment(apply_noise=False) on the same key's decisions.
    atol 1e-4 on the 0-255 scale: two lerps in float32, fused differently."""
    b, t, h, w, out_hw, p = 6, 3, 80, 96, (32, 40), 0.5
    clips = np.random.default_rng(seed).uniform(0, 255, (b, t, h, w, 3)).astype(np.float32)
    key = jax.random.key(seed)
    ref = np.asarray(jax.vmap(
        lambda c, k: jaugment.crowd11_augment(c, k, out_hw, p, apply_noise=False)
    )(clips, jax.random.split(key, b)))
    do_crop, y0, x0, flip = _jax_decisions(key, b, (h, w), p)
    assert 0 < do_crop.sum() < b or 0 < flip.sum() < b  # the seeds mix the cases
    off = torch.zeros(b, dtype=torch.bool)
    d = augment.AugmentDecisions(
        torch.tensor(do_crop), torch.tensor(y0), torch.tensor(x0), torch.tensor(flip),
        off, off, seed=1,
    )
    got = augment.crowd11_augment_from_decisions(torch.from_numpy(clips), out_hw, d).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_identity_resize_matches_jax(torch, augment):
    """Whole-frame resize (down in H, up in W) == JAX identity_resize_batch,
    atol 1e-4 as above."""
    from crowded_scenes_ensemble_classification_tpu_torch.ops.resize import resize_bilinear

    clips = np.random.default_rng(3).uniform(0, 255, (2, 2, 50, 30, 3)).astype(np.float32)
    ref = np.asarray(jaugment.identity_resize_batch(jnp.asarray(clips), (24, 48)))
    got = augment.identity_resize_batch(torch.from_numpy(clips), (24, 48)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    np.testing.assert_array_equal(resize_bilinear(torch.from_numpy(clips), (24, 48)).numpy(), got)


def test_draw_decisions_ranges_and_replay(torch, augment):
    """Offsets lie in [0, margin]; gates fire at about p; the same
    generator seed replays the same decisions."""
    g = lambda: torch.Generator().manual_seed(42)  # noqa: E731
    a = augment.draw_decisions(g(), 4000, (256, 256), p=0.75)
    b = augment.draw_decisions(g(), 4000, (256, 256), p=0.75)
    for name in ("do_crop", "y0", "x0", "flip", "salt", "pepper"):
        assert torch.equal(getattr(a, name), getattr(b, name))
    assert a.seed == b.seed and 0 <= a.seed < 2**62
    assert int(a.y0.min()) == 0 and int(a.y0.max()) == augment.CROP_MARGIN
    for gate in (a.do_crop, a.flip, a.salt, a.pepper):
        assert 0.72 < gate.float().mean().item() < 0.78


def test_augment_batch_applies_noise_with_its_gates(torch, augment):
    """crowd11_augment_batch draws its decisions and runs the noise with
    their gates: noise hits appear only in clips whose gates are on."""
    clips = torch.full((8, 2, 72, 72, 3), 128.0)
    out = augment.crowd11_augment_batch(clips, (32, 32), 0.5, torch.Generator().manual_seed(3))
    d = augment.draw_decisions(torch.Generator().manual_seed(3), 8, (72, 72), 0.5)
    assert out.shape == (8, 2, 32, 32, 3)
    hit = ((out == 0.0) | (out == 255.0)).flatten(1).any(1)  # resized values stay near 128
    assert torch.equal(hit, d.salt | d.pepper)

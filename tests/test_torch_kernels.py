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


def test_wrappers_refuse_devices_they_do_not_run(torch, maxpool, noise):
    """No silent fallback: a tensor that is neither CPU nor CUDA raises."""
    x = torch.empty(1, 2, 3, 3, 8, device="meta")
    with pytest.raises(ValueError):
        maxpool.max_pool_3x3x3_same(x)
    gates = torch.zeros(1, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        noise.salt_pepper(x, 1, gates, gates, 100)


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

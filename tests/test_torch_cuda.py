"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device.  This
file imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch; there, skip tests/conftest.py (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda -q

torch is imported by the fixture, not at collection (see
tests/torch_port_memory.py).
"""

import pytest

pytestmark = pytest.mark.cuda


@pytest.fixture
def torch():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "shape",
    [(2, 10, 28, 28, 192), (2, 5, 14, 14, 528), (1, 1, 3, 3, 3), (2, 3, 5, 7, 130), (1, 4, 6, 6, 12)],
)
def test_maxpool_kernel_equals_plain(torch, shape, dtype):
    """Kernel == plain version exactly, vector path and masked tail, and one
    launch counted per call."""
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import (
        max_pool_3x3x3_reference,
        max_pool_3x3x3_same,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(shape, device="cuda", generator=gen).to(getattr(torch, dtype))
    before = max_pool_3x3x3_same.launches
    got = max_pool_3x3x3_same(x)
    torch.cuda.synchronize()
    assert max_pool_3x3x3_same.launches == before + 1
    assert torch.equal(got, max_pool_3x3x3_reference(x))


def test_maxpool_kernel_propagates_nan(torch):
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import (
        max_pool_3x3x3_same,
    )

    x = torch.zeros(1, 3, 3, 3, 8, device="cuda")
    x[0, 1, 1, 1, 0] = float("nan")
    got = max_pool_3x3x3_same(x)
    assert torch.isnan(got[..., 0]).all() and not torch.isnan(got[..., 1:]).any()


def test_maxpool_kernel_rejects_what_it_does_not_take(torch):
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import (
        max_pool_3x3x3_same,
    )

    with pytest.raises(TypeError):
        max_pool_3x3x3_same(torch.zeros(1, 2, 3, 3, 8, device="cuda", dtype=torch.float16))
    with pytest.raises(ValueError):
        max_pool_3x3x3_same(torch.zeros(1, 2, 3, 3, 8, device="cuda").transpose(1, 2))


@pytest.mark.parametrize("shape", [(3, 4, 32, 32, 3), (2, 5, 7, 7, 3)])
def test_noise_kernel_equals_plain(torch, shape):
    """Kernel == plain version with the same Philox bits, exactly, at a
    length divisible by 4 and at one that is not."""
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels import noise

    x = torch.randint(0, 256, shape, device="cuda").float()
    salt = torch.tensor([True, False, True][: shape[0]], device="cuda")
    pepper = torch.tensor([True, True, False][: shape[0]], device="cuda")
    before = noise.salt_pepper.launches
    got = noise.salt_pepper(x, 2**50 + 3, salt, pepper, 100)
    torch.cuda.synchronize()
    assert noise.salt_pepper.launches == before + 1
    assert torch.equal(got, noise.salt_pepper_plain(x, 2**50 + 3, salt, pepper, 100))

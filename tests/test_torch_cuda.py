"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device.  This
file imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch; there, skip tests/conftest.py (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda -q

torch is imported by the fixture, not at collection (see
tests/torch_port_memory.py).
"""

import math

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
    [(2, 10, 28, 28, 192), (2, 5, 14, 14, 528), (1, 1, 3, 3, 3), (2, 3, 5, 7, 130), (1, 4, 6, 6, 12),
     (2, 4, 30, 28, 64), (16, 5, 14, 14, 528), (2, 1, 5, 5, 64), (1, 2, 6, 6, 16), (2, 2, 7, 7, 832)],
)
def test_maxpool_kernel_equals_plain(torch, shape, dtype):
    """Kernel == plain version exactly, 16-byte and single-element units,
    and one launch counted per call.  The ragged cases of the tiler: H not
    a multiple of the H-tile (30), a partial last C-block (528), T = 1 and
    T = 2, C not a multiple of the unit (3, 130, 12 in bf16)."""
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_maxpool_kernel_propagates_nan_across_tiles(torch, dtype):
    """A NaN on an H-tile's halo row (the first row of the next tile) and
    NaNs in the first and the last temporal plane come out where the plain
    version puts them, and nowhere else."""
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import (
        max_pool_3x3x3_reference,
        max_pool_3x3x3_same,
        max_pool_tiling,
    )

    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((2, 4, 30, 28, 64), device="cuda", generator=gen).to(getattr(torch, dtype))
    ht = max_pool_tiling(x.shape, x.element_size(), sms=torch.cuda.get_device_properties(0).multi_processor_count).ht
    assert ht < 30
    x[1, 1, ht, 5, 3] = x[0, 0, 0, 0, 0] = x[0, 3, 29, 27, 63] = float("nan")
    got, ref = max_pool_3x3x3_same(x), max_pool_3x3x3_reference(x)
    assert torch.equal(got.isnan(), ref.isnan()) and int(ref.isnan().sum()) == 27 + 8 + 8
    assert torch.equal(got.nan_to_num(), ref.nan_to_num())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_maxpool_kernel_misaligned_input(torch, dtype):
    """An input that starts off a 16-byte boundary takes the single-element
    units of the same kernel and still equals the plain version."""
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import (
        max_pool_3x3x3_reference,
        max_pool_3x3x3_same,
    )

    shape = (2, 3, 9, 7, 64)
    flat = torch.randn(1 + torch.Size(shape).numel(), device="cuda").to(getattr(torch, dtype))
    x = flat[1:].view(shape)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    before = max_pool_3x3x3_same.launches
    got = max_pool_3x3x3_same(x)
    assert max_pool_3x3x3_same.launches == before + 1
    assert torch.equal(got, max_pool_3x3x3_reference(x))


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


@pytest.fixture
def no_tf32(torch):
    """f32 convolutions in full f32 on the card (cuDNN defaults to TF32)."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.parametrize(
    "dtype,shape,features,atol",
    [
        ("float32", (2, 4, 28, 28, 3), 16, 1e-4),  # summation order
        ("float32", (1, 6, 28, 36, 3), 16, 1e-4),
        ("bfloat16", (2, 4, 28, 28, 3), 16, 0.0625),  # bf16 rounding of the output
        ("bfloat16", (1, 6, 28, 36, 3), 64, 0.0625),
        # ragged for the persistent bf16 tiler: H/2, W/2 not multiples of
        # 16, T=2 (taps skipped at both ends), F-parts of 8, 32, 40, 64
        ("bfloat16", (2, 2, 40, 52, 3), 8, 0.0625),
        ("bfloat16", (2, 2, 40, 52, 3), 32, 0.0625),
        ("bfloat16", (2, 2, 40, 52, 3), 64, 0.0625),
        ("bfloat16", (1, 6, 70, 46, 3), 64, 0.0625),
        ("bfloat16", (2, 4, 36, 38, 3), 40, 0.0625),
        ("bfloat16", (1, 4, 34, 30, 2), 64, 0.0625),  # C=2: the 4C = 8 kernel
        ("bfloat16", (1, 2, 30, 28, 1), 16, 0.0625),  # C=1: the 4C = 4 kernel
    ],
)
def test_stem_kernel_equals_plain(torch, no_tf32, dtype, shape, features, atol):
    """The stem kernel against its plain version (TF-SAME pad + conv3d),
    f32 FMA path and bf16 tensor-core path, output tiles cut at ragged
    edges; one launch counted per call."""
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.stem_conv import (
        stem_conv_7x7x7_s2,
        stem_conv_7x7x7_s2_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = getattr(torch, dtype)
    x = torch.randn(shape, device="cuda", generator=gen).to(dt)
    w = (torch.randn((features, shape[-1], 7, 7, 7), device="cuda", generator=gen) * 0.05).to(dt)
    before = stem_conv_7x7x7_s2.launches
    got = stem_conv_7x7x7_s2(x, w)
    torch.cuda.synchronize()
    assert stem_conv_7x7x7_s2.launches == before + 1
    ref = stem_conv_7x7x7_s2_reference(x, w)
    assert got.shape == ref.shape and got.dtype == dt
    torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=atol)


def test_stem_kernel_rejects_what_it_does_not_take(torch):
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.stem_conv import stem_conv_7x7x7_s2

    w = torch.zeros(16, 3, 7, 7, 7, device="cuda")
    with pytest.raises(TypeError):
        stem_conv_7x7x7_s2(torch.zeros(1, 4, 8, 8, 3, device="cuda", dtype=torch.float16), w.half())
    with pytest.raises(ValueError):
        stem_conv_7x7x7_s2(torch.zeros(1, 8, 4, 8, 3, device="cuda").transpose(1, 2), w)
    with pytest.raises(ValueError):
        stem_conv_7x7x7_s2(torch.zeros(1, 4, 7, 8, 3, device="cuda"), w)
    with pytest.raises(ValueError):
        stem_conv_7x7x7_s2(torch.zeros(1, 4, 8, 8, 3, device="cuda"), w[:, :2])
    with pytest.raises(ValueError):
        stem_conv_7x7x7_s2(torch.zeros(1, 4, 8, 8, 3, device="cuda", dtype=torch.bfloat16),
                           torch.zeros(12, 3, 7, 7, 7, device="cuda", dtype=torch.bfloat16))
    with pytest.raises(ValueError):  # 4C = 16: the weights and two slabs exceed 227 KB
        stem_conv_7x7x7_s2(torch.zeros(1, 4, 8, 8, 4, device="cuda", dtype=torch.bfloat16),
                           torch.zeros(16, 4, 7, 7, 7, device="cuda", dtype=torch.bfloat16))


def test_stem_bf16_launch_config(torch):
    """One block per SM split evenly over the F-parts; RGB takes 89,600 B of
    resident weights plus two 61,712 B slabs; a request above the device's
    limit (4C = 16) raises rather than launching nothing."""
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.stem_conv import stem_bf16_launch_config

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert stem_bf16_launch_config(torch.device("cuda"), 3, 64) == (sms // 2 * 2, 89_600 + 2 * 61_712)
    assert stem_bf16_launch_config(torch.device("cuda"), 3, 32)[0] == sms
    with pytest.raises(RuntimeError):
        stem_bf16_launch_config(torch.device("cuda"), 4, 64)


def test_exported_model_launches_the_kernels(torch, no_tf32, tmp_path):
    """A tiny I3D with the kernel stem, exported on the card, saved and
    loaded: the loaded program launches the stem once and the max pool 9
    times per call, and serves what the eager model computes."""
    from crowded_scenes_ensemble_classification_tpu_torch.core.config import ClipSpec
    from crowded_scenes_ensemble_classification_tpu_torch.models.i3d import I3D
    from crowded_scenes_ensemble_classification_tpu_torch.models.registry import ModelBundle
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import max_pool_3x3x3_same
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.stem_conv import stem_conv_7x7x7_s2
    from crowded_scenes_ensemble_classification_tpu_torch.serving import (
        export_ensemble,
        load_serving_artifact,
        save_serving_artifact,
        serving_batch_example,
    )

    model = I3D(11, frames=16, stem_impl="pallas", generator=torch.Generator().manual_seed(0))
    bundle = ModelBundle("I3D", model.cuda().eval(), ClipSpec(16, 32, 32), 11, False)
    example = serving_batch_example(bundle, 2)
    program = export_ensemble([bundle], example, input_scale=1 / 255.0)
    serve, _ = load_serving_artifact(save_serving_artifact(str(tmp_path / "a.zip"), program, {}))
    batch = {"rgb": torch.randint(0, 256, example["rgb"].shape, dtype=torch.uint8, device="cuda")}
    launches = (stem_conv_7x7x7_s2.launches, max_pool_3x3x3_same.launches)
    out = serve(batch)
    torch.cuda.synchronize()
    assert (stem_conv_7x7x7_s2.launches - launches[0], max_pool_3x3x3_same.launches - launches[1]) == (1, 9)
    with torch.no_grad():
        eager = torch.softmax(model(batch["rgb"].float() * (1 / 255.0)), dim=-1)
    torch.testing.assert_close(out["probs"][0], eager, rtol=1e-5, atol=1e-5)


def _tie_heavy(torch, shape, gen):
    """Integer x in 0..3 with the first half of H zeroed (ties and the ReLU
    plateau), and dy in multiples of 1/8, so sums are exact in any order."""
    x = torch.randint(-3, 4, shape, device="cuda", generator=gen).clamp_min_(0).float()
    x[:, :, : shape[2] // 2] = 0
    return x, torch.randint(-8, 8, shape, device="cuda", generator=gen).float() / 8


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "shape,nans",
    [((2, 10, 28, 28, 192), False), ((2, 5, 14, 14, 528), False), ((2, 3, 7, 7, 832), False),
     ((1, 1, 3, 3, 3), False), ((2, 3, 5, 7, 130), False), ((2, 4, 30, 28, 64), False), ((2, 1, 5, 5, 64), False),
     ((1, 2, 6, 6, 16), False), ((4100, 16, 2, 2, 8), False), ((2, 4, 30, 28, 64), True),
     ((2, 5, 14, 14, 528), True)],
)
def test_maxpool_backward_kernel_equals_plain(torch, shape, nans, dtype, offset):
    """The gradient kernel against its plain version on tie-heavy inputs, at
    Mixed-block shapes (B=2) and ragged ones, B·T above 65535 (4100 × 16),
    and with NaNs on an H-tile's first row and on both sides of a C-block
    edge: f32 reaches the same inputs and agrees within 1e-6·max|dy|; bf16
    (summed in f32, rounded once) within one bf16 rounding of the f32 plain
    result.  One launch counted a call."""
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import (
        max_pool_3x3x3_backward_reference,
        max_pool_3x3x3_same_backward,
        max_pool_backward_tiling,
    )

    gen = torch.Generator(device="cuda").manual_seed(1)
    x32, dy32 = _tie_heavy(torch, shape, gen)
    dt = getattr(torch, dtype)
    if nans:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        tiling = max_pool_backward_tiling(shape, dt.itemsize, sms=sms)
        assert tiling.ht < shape[2] and tiling.cb < shape[4]
        x32[0, 1, tiling.ht, 3, tiling.cb - 1] = x32[0, 1, tiling.ht - 1, 4, tiling.cb] = float("nan")
        x32[-1, -1, -1, -1, -1] = x32[0, 0, 0, 0, 0] = float("nan")
    ref = max_pool_3x3x3_backward_reference(x32, dy32)
    n = x32.numel()
    x = torch.empty(n + offset, dtype=dt, device="cuda")[offset:].view(shape).copy_(x32)
    dy = torch.empty(n + offset, dtype=dt, device="cuda")[offset:].view(shape).copy_(dy32)
    before = max_pool_3x3x3_same_backward.launches
    got = max_pool_3x3x3_same_backward(x, dy).float()
    torch.cuda.synchronize()
    assert max_pool_3x3x3_same_backward.launches == before + 1
    if dt == torch.float32:
        assert torch.equal(got != 0, ref != 0)
        assert (got - ref).abs().max().item() <= 1e-6 * dy32.abs().max().item()
    else:
        assert bool(((got - ref).abs() <= ref.abs() * 2.0**-8).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_maxpool_backward_kernel_is_deterministic(torch, dtype):
    """Two calls on the same normal inputs give the same bits: a fixed
    summation order, no atomics."""
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import max_pool_3x3x3_same_backward

    gen = torch.Generator(device="cuda").manual_seed(3)
    x, dy = (torch.randn((2, 10, 28, 28, 192), device="cuda", generator=gen).to(getattr(torch, dtype))
             for _ in range(2))
    assert torch.equal(max_pool_3x3x3_same_backward(x, dy), max_pool_3x3x3_same_backward(x, dy))


def test_maxpool_backward_kernel_through_autograd(torch):
    """backward() through the forward op runs the gradient kernel once and
    equals the plain version's autograd (f32, normal inputs: no ties) to
    rtol = atol = 1e-5: each value sums up to 27 dy of N(0, 1), which the
    plain version adds by atomics in no fixed order."""
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import (
        max_pool_3x3x3_reference,
        max_pool_3x3x3_same,
        max_pool_3x3x3_same_backward,
    )

    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(2, 5, 14, 14, 480, device="cuda", generator=gen, requires_grad=True)
    dy = torch.randn(x.shape, device="cuda", generator=gen)
    before = max_pool_3x3x3_same_backward.launches
    (g,) = torch.autograd.grad(max_pool_3x3x3_same(x), x, dy)
    (want,) = torch.autograd.grad(max_pool_3x3x3_reference(x), x, dy)
    assert max_pool_3x3x3_same_backward.launches == before + 1
    torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-5)


def test_maxpool_backward_kernel_rejects_what_it_does_not_take(torch):
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import max_pool_3x3x3_same_backward

    x = torch.zeros(1, 3, 4, 4, 8, device="cuda")
    with pytest.raises(ValueError):
        max_pool_3x3x3_same_backward(x, torch.zeros(1, 3, 4, 4, 4, device="cuda"))
    with pytest.raises(TypeError):
        max_pool_3x3x3_same_backward(x, x.half())
    with pytest.raises(ValueError):
        max_pool_3x3x3_same_backward(x.transpose(2, 3), x)


def _relative_error(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def test_train_step_kernels_equal_plain(torch, no_tf32):
    """One f32 resident train step of the full-width I3D (B=4, 20×224² from
    256² uint8 staging, augment on) through the kernels against the same
    step through the plain versions (cuDNN deterministic): every gradient
    and updated parameter within 1e-4 relative error (‖a − b‖/‖b‖); 9
    forward and 9 backward max-pool launches and 1 noise launch."""
    from unittest import mock

    import numpy as np

    import crowded_scenes_ensemble_classification_tpu_torch.models.i3d as i3d_mod
    import crowded_scenes_ensemble_classification_tpu_torch.ops.augment as augment_mod
    from crowded_scenes_ensemble_classification_tpu_torch.data.resident import ResidentClips
    from crowded_scenes_ensemble_classification_tpu_torch.models import build_model
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import (
        max_pool_3x3x3_reference,
        max_pool_3x3x3_same,
        max_pool_3x3x3_same_backward,
    )
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.noise import salt_pepper, salt_pepper_plain
    from crowded_scenes_ensemble_classification_tpu_torch.train import TrainState, make_optimizer, make_resident_train_step

    rng = np.random.default_rng(3)
    data = ResidentClips({"rgb": rng.integers(0, 256, (4, 20, 256, 256, 3), dtype=np.uint8)}, [1, 5, 5, 9], 4)
    batch = next(data.batches(0))
    torch.backends.cudnn.deterministic = True
    runs = []
    try:
        for plain in (False, True):
            bundle = build_model("I3D", generator=torch.Generator().manual_seed(4), trainable=True)
            tx = make_optimizer("I3D", 0.003)
            step = make_resident_train_step(bundle, tx, (224, 224), augment=True, input_scale=1 / 255)
            counts = (max_pool_3x3x3_same.launches, max_pool_3x3x3_same_backward.launches, salt_pepper.launches)
            with mock.patch.object(i3d_mod, "max_pool_3x3x3_same", max_pool_3x3x3_reference if plain
                                   else max_pool_3x3x3_same), \
                    mock.patch.object(augment_mod, "salt_pepper", salt_pepper_plain if plain else salt_pepper):
                step(TrainState.create(bundle.module, tx, seed=5), batch, torch.ones(11, device="cuda"))
            after = (max_pool_3x3x3_same.launches, max_pool_3x3x3_same_backward.launches, salt_pepper.launches)
            assert [a - b for a, b in zip(after, counts)] == ([0, 0, 0] if plain else [9, 9, 1])
            runs.append({n: (p.grad, p.detach()) for n, p in bundle.module.named_parameters() if p.requires_grad})
    finally:
        torch.backends.cudnn.deterministic = False
    for name, (grad, param) in runs[1].items():
        assert _relative_error(runs[0][name][0], grad) <= 1e-4, name
        assert _relative_error(runs[0][name][1], param) <= 1e-4, name


def test_kernel_stem_weight_gradient_matches_canonical(torch):
    """PallasStemConvBN in train mode (bf16 compute, f32 master weight)
    against the canonical ConvBN on the same weights and clips, B=2 at
    20×224²: weight gradients within 2e-2 relative error (bf16 rounding of
    the two forward convs)."""
    from crowded_scenes_ensemble_classification_tpu_torch.models.common import ConvBN, PallasStemConvBN, to_ncdhw

    gen = torch.Generator().manual_seed(6)
    kernel_stem = PallasStemConvBN(3, 64, generator=gen).cuda().train()
    canonical = ConvBN(3, 64, (7, 7, 7), (2, 2, 2)).cuda().train()
    canonical.load_state_dict(kernel_stem.state_dict())
    x = to_ncdhw(torch.randn(2, 20, 224, 224, 3, generator=gen).to("cuda", torch.bfloat16))
    r = torch.randn(2, 64, 10, 112, 112, generator=gen).cuda()
    grads = []
    for stem in (kernel_stem, canonical):
        (stem(x).float() * r).sum().backward()
        grads.append(stem.conv.weight.grad)
    assert grads[1].abs().max().item() > 0
    assert _relative_error(grads[0], grads[1]) <= 2e-2


def _spread_batchnorm(torch, module, gen):
    """BN statistics and biases drawn away from (0, 1), so every layer matters."""
    for m in module.modules():
        if isinstance(m, torch.nn.BatchNorm3d):
            m.running_var.uniform_(0.3, 0.7, generator=gen)
            m.running_mean.normal_(0.0, 0.1, generator=gen)
            m.bias.data.normal_(0.0, 0.1, generator=gen)


def _small_family(torch, model_type, gen, prestaged=False, hw=32, quant=False):
    """A CPU module of `model_type` (C3D and R3D at width 0.125, C3D for
    16×hw² clips), random weights from `gen`, BN spread, in eval mode;
    quantized with `quant`."""
    from crowded_scenes_ensemble_classification_tpu_torch.models.c3d import C3D
    from crowded_scenes_ensemble_classification_tpu_torch.models.i3d import I3D
    from crowded_scenes_ensemble_classification_tpu_torch.models.r3d import R3D
    from crowded_scenes_ensemble_classification_tpu_torch.models.two_stream_i3d import TwoStreamI3D

    if model_type == "C3D":
        module = C3D(11, 0.125, clip_thw=(16, hw, hw), generator=gen, quant=quant)
    elif model_type.startswith("R3D_"):
        module = R3D(11, int(model_type.split("_")[1]), 0.125, generator=gen, quant=quant)
    elif model_type == "I3D":
        module = I3D(11, frames=16, stem_prestaged=prestaged, generator=gen, quant=quant)
    else:
        module = TwoStreamI3D(11, frames=16, stem_prestaged=prestaged, generator=gen, quant=quant)
    _spread_batchnorm(torch, module, gen)
    return module.eval()


@pytest.mark.parametrize("model_type", ["C3D", "R3D_18", "R3D_50", "I3D", "TWOSTREAM_I3D"])
def test_family_f32_on_card_matches_cpu(torch, no_tf32, model_type):
    """Each family in f32 on the card (cuDNN, TF32 off, the max-pool kernel
    for the I3D family) against the same module on the CPU (plain versions)
    at (2, 16, 32, 32): logits within 1e-4 relative error."""
    gen = torch.Generator().manual_seed(7)
    cpu = _small_family(torch, model_type, gen)
    x = [torch.rand(2, 16, 32, 32, c, generator=gen) for c in ((3, 2) if model_type == "TWOSTREAM_I3D" else (3,))]
    with torch.inference_mode():
        ref = cpu(*x)
        got = cpu.cuda()(*[t.cuda() for t in x]).cpu()
    assert ref.std(-1).min() > 0
    assert _relative_error(got, ref) <= 1e-4


def test_hetero_step_launches_the_max_pool_kernel(torch, no_tf32):
    """hetero_ensemble_step on the card with 4 members each of I3D,
    TwoStream-I3D (prestaged), C3D and R3D-18 (width 0.125) at (1, 16, 32,
    32): 108 max-pool launches a step (9 per I3D trunk), and probabilities
    within 1e-5 of the same step on the CPU with equal fused predictions."""
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.pipeline import hetero_ensemble_step
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import max_pool_3x3x3_same

    gen = torch.Generator().manual_seed(8)
    families = {mt: [_small_family(torch, mt, gen, prestaged=True, hw=16) for _ in range(4)]
                for mt in ("I3D", "TWOSTREAM_I3D", "C3D", "R3D_18")}
    rgb, flow = (torch.randint(0, 256, (1, 16, 32, 32, c), generator=gen).float() for c in (3, 2))
    ref_probs, ref_preds = hetero_ensemble_step(families, rgb / 255, flow / 255)
    for members in families.values():
        for m in members:
            m.cuda()
    before = max_pool_3x3x3_same.launches
    for _ in range(2):
        probs, preds = hetero_ensemble_step(families, rgb.cuda() / 255, flow.cuda() / 255)
    torch.cuda.synchronize()
    assert max_pool_3x3x3_same.launches - before == 2 * 108
    assert probs.shape == (16, 1, 11)
    torch.testing.assert_close(probs.cpu(), ref_probs, rtol=0, atol=1e-5)
    assert torch.equal(preds.cpu(), ref_preds)


def _flow_pairs(torch, n, size, seed):
    """The JAX bench's flow pairs (bench.py:343-356): a sinusoidal scene with
    ±3 noise, and the same scene moved by (1, 2) with fresh noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    base = 128 + 60 * np.sin(xx / 17.0) + 50 * np.cos(yy / 23.0)
    prev = np.stack([base + rng.integers(-3, 4, (size, size)) for _ in range(n)])
    curr = np.stack([np.roll(base, (1, 2), (0, 1)) + rng.integers(-3, 4, (size, size)) for _ in range(n)])
    return torch.from_numpy(prev.astype(np.float32)), torch.from_numpy(curr.astype(np.float32))


@pytest.mark.parametrize("schedule", ["turbo", "full"])
def test_farneback_on_card_matches_cpu_with_tf32_on(torch, schedule):
    """Farnebäck on the card against the same function on the CPU, 4 pairs
    of 224², with TF32 allowed for cuDNN (PyTorch's default) and for
    matmuls: the flow never reaches either (shifted-slice float32
    correlations, the 6×6 solve as multiplies and adds), so the fields
    agree within 1e-4 px, and the caller's flags come back unchanged."""
    from crowded_scenes_ensemble_classification_tpu_torch.flow.farneback import (
        TURBO_PARAMS,
        farneback_flow_batch,
    )

    kw = dict(TURBO_PARAMS) if schedule == "turbo" else dict(fast_warp=True)
    prev, curr = _flow_pairs(torch, 4, 224, 0)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        assert torch.backends.cudnn.allow_tf32  # PyTorch's default
        got = farneback_flow_batch(prev.cuda(), curr.cuda(), chunk_pairs=3, **kw)
        torch.cuda.synchronize()
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    ref = farneback_flow_batch(prev, curr, **kw)
    assert got.shape == ref.shape == (4, 224, 224, 2) and got.is_cuda
    assert (got.cpu() - ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tvl1_on_card_matches_cpu(torch, dtype):
    """TV-L1 (3 levels, the default warps and dual steps) on the card
    against the CPU, 2 pairs of 96²: f32 within 1e-3 px; with bf16 duals
    within 0.05 px on average (bf16 rounding in a loop of 150 steps)."""
    from crowded_scenes_ensemble_classification_tpu_torch.flow.tvl1 import tvl1_flow_pair

    prev, curr = _flow_pairs(torch, 2, 96, 1)
    kw = dict(levels=3, compute_dtype=getattr(torch, dtype))
    got = tvl1_flow_pair(prev.cuda(), curr.cuda(), **kw).cpu()
    ref = tvl1_flow_pair(prev, curr, **kw)
    d = (got - ref).abs()
    assert got.dtype == torch.float32 and got.shape == (2, 96, 96, 2)
    if dtype == "float32":
        assert d.max().item() <= 1e-3
    else:
        assert d.mean().item() <= 0.05


def test_two_stream_member_probabilities_on_gray_pairs(torch, no_tf32):
    """member_probabilities of 2 TwoStream members (prestaged, f32) over
    two batches of gray pairs staged at 40² (B=2, 16 frames) with rgb: the
    flow computed on the card by turbo Farnebäck, 18 max-pool launches a
    member a batch, probabilities within 1e-4 of the CPU's."""
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.members import member_probabilities
    from crowded_scenes_ensemble_classification_tpu_torch.flow.farneback import TURBO_PARAMS
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import max_pool_3x3x3_same

    gen = torch.Generator().manual_seed(9)
    members = [_small_family(torch, "TWOSTREAM_I3D", gen, prestaged=True) for _ in range(2)]
    prev, curr = _flow_pairs(torch, 2 * 2 * 16, 40, 2)
    batches = [{"rgb": prev[32 * i: 32 * (i + 1)].reshape(2, 16, 40, 40, 1).expand(2, 16, 40, 40, 3) / 255.0,
                "gray": prev[32 * i: 32 * (i + 1)].reshape(2, 16, 40, 40, 1),
                "gray_next": curr[32 * i: 32 * (i + 1)].reshape(2, 16, 40, 40, 1)} for i in range(2)]
    ref = member_probabilities(members, batches, (32, 32), flow_params=TURBO_PARAMS)
    for m in members:
        m.cuda()
    before = max_pool_3x3x3_same.launches
    got = member_probabilities(members, batches, (32, 32), flow_params=TURBO_PARAMS)
    assert max_pool_3x3x3_same.launches - before == 2 * 2 * 18
    assert got.shape == ref.shape == (2, 4, 11)
    assert abs(got - ref).max() <= 1e-4


def _two_stream_train_setup(torch, seed, dtype=None):
    """A trainable TwoStream-I3D for 16-frame 32² clips on the card (weights
    drawn on the CPU from `seed`), its optimizer and train step (augment on,
    turbo Farnebäck of gray pairs from the augmented pairs), and one batch
    of 2 clips staged at 40²: uint8 rgb and moving gray pairs."""
    from crowded_scenes_ensemble_classification_tpu_torch.core.config import ClipSpec
    from crowded_scenes_ensemble_classification_tpu_torch.flow.farneback import TURBO_PARAMS
    from crowded_scenes_ensemble_classification_tpu_torch.models.registry import ModelBundle
    from crowded_scenes_ensemble_classification_tpu_torch.models.two_stream_i3d import TwoStreamI3D
    from crowded_scenes_ensemble_classification_tpu_torch.train import make_optimizer, make_train_step

    module = TwoStreamI3D(11, frames=16, generator=torch.Generator().manual_seed(seed)).cuda().train()
    module.compute_dtype = dtype
    bundle = ModelBundle("TWOSTREAM_I3D", module, ClipSpec(16, 32, 32), 11, True, trainable=True)
    tx = make_optimizer("TWOSTREAM_I3D", 0.003)
    step = make_train_step(bundle, tx, (32, 32), augment=True, input_scale=1 / 255, flow_params=TURBO_PARAMS,
                           flow_from_augmented=True)
    prev, curr = _flow_pairs(torch, 2 * 16, 40, seed)
    batch = {"rgb": torch.randint(0, 256, (2, 16, 40, 40, 3), generator=torch.Generator().manual_seed(seed),
                                  dtype=torch.uint8),
             "gray": prev.reshape(2, 16, 40, 40, 1), "gray_next": curr.reshape(2, 16, 40, 40, 1),
             "label": torch.tensor([2, 9]), "valid": torch.ones(2, dtype=torch.bool)}
    return bundle, tx, step, batch


def _kernel_launches():
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import (
        max_pool_3x3x3_same,
        max_pool_3x3x3_same_backward,
    )
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.noise import salt_pepper

    return (max_pool_3x3x3_same.launches, max_pool_3x3x3_same_backward.launches, salt_pepper.launches)


def test_two_stream_train_step_kernels_equal_plain(torch, no_tf32):
    """One f32 TwoStream train step on the card (augment on, flow computed
    from the augmented gray pairs) through the kernels against the same
    step through the plain versions (cuDNN deterministic): every gradient
    and updated parameter within 1e-4 relative error; the kernel run
    launches the max pool 18 times, its gradient 18 times and the noise
    once, the plain run none."""
    from unittest import mock

    import crowded_scenes_ensemble_classification_tpu_torch.models.i3d as i3d_mod
    import crowded_scenes_ensemble_classification_tpu_torch.ops.augment as augment_mod
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import max_pool_3x3x3_reference
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.noise import salt_pepper_plain
    from crowded_scenes_ensemble_classification_tpu_torch.train import TrainState

    torch.backends.cudnn.deterministic = True
    runs = []
    try:
        for plain in (False, True):
            bundle, tx, step, batch = _two_stream_train_setup(torch, 12)
            before = _kernel_launches()
            if plain:
                with mock.patch.object(i3d_mod, "max_pool_3x3x3_same", max_pool_3x3x3_reference), \
                        mock.patch.object(augment_mod, "salt_pepper", salt_pepper_plain):
                    step(TrainState.create(bundle.module, tx, seed=3), batch, torch.ones(11, device="cuda"))
            else:
                step(TrainState.create(bundle.module, tx, seed=3), batch, torch.ones(11, device="cuda"))
            torch.cuda.synchronize()
            assert [a - b for a, b in zip(_kernel_launches(), before)] == ([0, 0, 0] if plain else [18, 18, 1])
            runs.append({n: (p.grad, p.detach()) for n, p in bundle.module.named_parameters() if p.requires_grad})
    finally:
        torch.backends.cudnn.deterministic = False
    for name, (grad, param) in runs[1].items():
        assert _relative_error(runs[0][name][0], grad) <= 1e-4, name
        assert _relative_error(runs[0][name][1], param) <= 1e-4, name


def test_two_stream_bf16_train_step_launches(torch):
    """A bf16 TwoStream train step on f32 master weights (the card's
    training form): 18 max-pool, 18 gradient and 1 noise launch a step over
    3 steps, finite losses, f32 gradients."""
    from crowded_scenes_ensemble_classification_tpu_torch.train import TrainState

    bundle, tx, step, batch = _two_stream_train_setup(torch, 13, torch.bfloat16)
    state = TrainState.create(bundle.module, tx)
    before = _kernel_launches()
    losses = [step(state, batch, torch.ones(11, device="cuda"))[1]["loss"] for _ in range(3)]
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_kernel_launches(), before)] == [54, 54, 3]
    assert all(torch.isfinite(x).item() for x in losses)
    assert all(p.grad.dtype == torch.float32 for p in bundle.module.parameters() if p.grad is not None)


@pytest.mark.parametrize("model_type", ["C3D", "R3D_18"])
def test_family_f32_train_step_on_card_matches_cpu(torch, no_tf32, model_type):
    """One f32 train step of C3D (dropout 0: its masks come from a device
    generator, which draws other bits on the card) and R3D-18 (Adam and
    its l2 term), width 0.125, 16×32² clips from 40² uint8 staging, augment
    on (decisions drawn on the host; the noise kernel equals its plain
    version), on the card against the same step on the CPU (cuDNN
    deterministic): loss within 1e-5; C3D's updated parameters within 1e-4
    relative error; R3D's gradients within 1e-4, and its parameters within
    2·lr, as Keras Adam's first step is lr·g/(|g| + eps), whose sign
    rounding decides where |g| is near zero.  R3D's conv biases feed
    train-mode BatchNorm, which removes them: their gradient is 0 but for
    rounding, under 1e-4 of the largest."""
    import numpy as np

    from crowded_scenes_ensemble_classification_tpu_torch.core.config import ClipSpec
    from crowded_scenes_ensemble_classification_tpu_torch.models.registry import ModelBundle
    from crowded_scenes_ensemble_classification_tpu_torch.train import TrainState, make_train_step, train_policy

    rng = np.random.default_rng(14)
    batch = {"rgb": torch.from_numpy(rng.integers(0, 256, (2, 16, 40, 40, 3), dtype=np.uint8)),
             "label": torch.tensor([1, 6]), "valid": torch.ones(2, dtype=torch.bool)}
    gen = torch.Generator().manual_seed(15)
    module = _small_family(torch, model_type, gen)
    out = []
    torch.backends.cudnn.deterministic = True
    try:
        for dev in ("cpu", "cuda"):
            m = _small_family(torch, model_type, gen).to(dev)
            m.load_state_dict(module.state_dict())
            if model_type == "C3D":
                m.dropout_rate = 0.0
            bundle = ModelBundle(model_type, m.train(), ClipSpec(16, 32, 32), 11, False, trainable=True)
            tx, l2 = train_policy(model_type)
            step = make_train_step(bundle, tx, (32, 32), augment=True, l2_weight=l2, input_scale=1 / 255)
            _, metrics = step(TrainState.create(m, tx, seed=4), batch, torch.ones(11, device=dev))
            out.append((metrics["loss"].item(),
                        {n: (p.detach().cpu(), p.grad.detach().cpu()) for n, p in m.named_parameters()}))
    finally:
        torch.backends.cudnn.deterministic = False
    (loss_cpu, cpu), (loss_card, card) = out
    assert abs(loss_card - loss_cpu) <= 1e-5 * abs(loss_cpu)
    if model_type == "C3D":
        for name, (ref, _) in cpu.items():
            assert _relative_error(card[name][0], ref) <= 1e-4, name
        return
    lr = tx.keywords["lr"]
    largest = max(g.abs().max().item() for _, g in cpu.values())
    for name, (ref, grad) in cpu.items():
        if name.endswith(".bias") and not name.endswith("bn.bias") and not name.startswith("predictions"):
            assert all(g.abs().max().item() <= 1e-4 * largest for g in (grad, card[name][1])), name
        else:
            assert _relative_error(card[name][1], grad) <= 1e-4, name
        assert (card[name][0] - ref).abs().max().item() <= 2 * lr * 1.001, name


# ----------------------------------------------------------------------
# int8 inference: csec::int8_conv3d and csec::quantize_int8
# ----------------------------------------------------------------------

_S, _V = ((1, 1), (1, 1), (1, 1)), ((0, 0), (0, 0), (0, 0))
# (x NTHWC, F, kernel, strides, pads): the prestaged rgb and flow stems
# (4C = 12 and 8, asymmetric temporal pads), I3D's 1³ and 3³ convs, Mixed_4c's
# b2_3x3 on Cin = 24, C3D conv1 and the R3D stem on C = 3, a 3³/2 TF-SAME
# conv on odd extents, a 1³/2 VALID projection, K = 27·512 (C3D conv5),
# odd C and F with asymmetric pads; then the wgmma design's edges: K not a
# multiple of its 128-byte stage (80, 27·48), F = 208 and 48 against its F
# tiles, M below one 128-row tile, M below one wave (split K, 1³ and 3³),
# strides (1, 2, 1) on C = 64, and C = 2 and 12 on the byte-gather and
# 4-byte routes; then the row-slab route (C = 16, no spatial pads): the
# stem's form at odd H and at Wo = 112 with F = 13, and a (3, 2, 4) kernel
# with odd Ho, Wo = 67 over two tiles and two F tiles.
INT8_CONV_CASES = [
    ((2, 10, 115, 115, 12), 64, (7, 4, 4), (2, 1, 1), ((2, 3), (0, 0), (0, 0))),
    ((1, 6, 19, 21, 8), 64, (7, 4, 4), (2, 1, 1), ((2, 3), (0, 0), (0, 0))),
    ((2, 10, 56, 56, 64), 64, (1, 1, 1), (1, 1, 1), _V),
    ((2, 10, 56, 56, 64), 192, (3, 3, 3), (1, 1, 1), _S),
    ((2, 5, 14, 14, 24), 64, (3, 3, 3), (1, 1, 1), _S),
    ((2, 3, 7, 7, 832), 384, (1, 1, 1), (1, 1, 1), _V),
    ((2, 16, 28, 28, 3), 8, (3, 3, 3), (1, 1, 1), _S),
    ((2, 16, 28, 28, 3), 16, (7, 7, 7), (2, 2, 2), ((2, 3), (2, 3), (2, 3))),
    ((2, 5, 7, 9, 64), 128, (3, 3, 3), (2, 2, 2), ((1, 1), (1, 1), (1, 1))),
    ((2, 5, 7, 9, 48), 96, (1, 1, 1), (2, 2, 2), _V),
    ((1, 2, 3, 3, 512), 40, (3, 3, 3), (1, 1, 1), _S),
    ((1, 3, 5, 7, 17), 13, (3, 3, 3), (1, 2, 1), ((1, 1), (0, 2), (1, 0))),
    ((2, 3, 9, 9, 80), 64, (1, 1, 1), (1, 1, 1), _V),
    ((2, 4, 7, 7, 48), 128, (3, 3, 3), (1, 1, 1), _S),
    ((2, 5, 14, 14, 96), 208, (3, 3, 3), (1, 1, 1), _S),
    ((2, 5, 14, 14, 480), 48, (1, 1, 1), (1, 1, 1), _V),
    ((1, 1, 3, 5, 64), 96, (3, 3, 3), (1, 1, 1), _S),
    ((16, 3, 7, 7, 832), 384, (1, 1, 1), (1, 1, 1), _V),
    ((4, 3, 7, 7, 160), 320, (3, 3, 3), (1, 1, 1), _S),
    ((2, 4, 9, 8, 64), 64, (3, 3, 3), (1, 2, 1), ((1, 1), (0, 1), (1, 1))),
    ((2, 4, 10, 10, 2), 16, (3, 3, 3), (1, 1, 1), _S),
    ((1, 3, 9, 9, 12), 24, (3, 3, 3), (1, 1, 1), _S),
    ((2, 10, 19, 21, 16), 64, (7, 4, 4), (2, 1, 1), ((2, 3), (0, 0), (0, 0))),
    ((1, 6, 9, 115, 16), 13, (7, 4, 4), (2, 1, 1), ((2, 3), (0, 0), (0, 0))),
    ((2, 4, 6, 70, 16), 72, (3, 2, 4), (1, 1, 1), ((1, 1), (0, 0), (0, 0))),
]


def _int8(torch, shape, gen):
    return torch.randint(-127, 128, shape, device="cuda", generator=gen, dtype=torch.int32).to(torch.int8)


@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("case", INT8_CONV_CASES, ids=lambda c: "x".join(map(str, c[0])) + f"-F{c[1]}")
def test_int8_conv_kernel_equals_plain(torch, case, with_bias):
    """The int8 conv kernel == its plain version (the exact float64
    integer conv, then the same f32 dequantize) bit for bit, at full-scale
    int8 operands; one launch counted per call."""
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.int8_conv import (
        int8_conv3d,
        int8_conv3d_reference,
        pack_int8_weights,
    )

    shape, f, kernel, strides, pads = case
    gen = torch.Generator(device="cuda").manual_seed(1)
    x8, k8 = _int8(torch, shape, gen), _int8(torch, (f, shape[-1], *kernel), gen)
    scale = torch.rand(f, device="cuda", generator=gen) * 1e-3
    bias = torch.randn(f, device="cuda", generator=gen) if with_bias else None
    before = int8_conv3d.launches
    got = int8_conv3d(x8, pack_int8_weights(k8), scale, bias, kernel, strides, pads)
    torch.cuda.synchronize()
    assert int8_conv3d.launches == before + 1
    ref = int8_conv3d_reference(x8, k8, scale, bias, strides, pads)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert torch.equal(got, ref)


@pytest.mark.parametrize("offset", [1, 4, 8])
def test_int8_conv_kernel_misaligned_input(torch, offset):
    """An int8 input 1, 4 or 8 bytes off 16-byte alignment takes
    register-gathered single bytes, or 4- or 8-byte asynchronous copies,
    and still equals the plain version."""
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.int8_conv import (
        int8_conv3d,
        int8_conv3d_reference,
        pack_int8_weights,
    )

    gen = torch.Generator(device="cuda").manual_seed(2)
    shape = (2, 4, 9, 9, 32)
    x8 = torch.empty(math.prod(shape) + offset, dtype=torch.int8, device="cuda")[offset:].view(shape)
    x8.copy_(_int8(torch, shape, gen))
    assert x8.data_ptr() % 16 == offset
    k8 = _int8(torch, (48, 32, 3, 3, 3), gen)
    scale = torch.rand(48, device="cuda", generator=gen)
    got = int8_conv3d(x8, pack_int8_weights(k8), scale, None, (3, 3, 3), (1, 1, 1), _S)
    assert torch.equal(got, int8_conv3d_reference(x8, k8, scale, None, (1, 1, 1), _S))


@pytest.mark.parametrize("features", [64, 128, 192, 256])
def test_int8_conv_single_wgmma_tile_equals_plain_product(torch, features):
    """One 128 × F × 128 tile, the kernel's unit (a 1³ conv of 128
    positions × 128 channels, F = each of its F tiles): the int32 sums,
    dequantized by 1, equal the int64 matrix product exactly (|Σ| ≤
    128·127² < 2^24, exact in f32).  A wrong shared-memory descriptor or
    swizzle gives wrong numbers, not a fault."""
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.int8_conv import (
        int8_conv3d,
        int8_conv_tiling,
        pack_int8_weights,
    )

    assert int8_conv_tiling(128, features, 128) == (features, 1)
    gen = torch.Generator(device="cuda").manual_seed(5)
    x8, k8 = _int8(torch, (1, 1, 1, 128, 128), gen), _int8(torch, (features, 128, 1, 1, 1), gen)
    got = int8_conv3d(x8, pack_int8_weights(k8), torch.ones(features, device="cuda"), None, (1, 1, 1),
                      (1, 1, 1), _V)
    want = x8.view(128, 128).cpu().long() @ k8.view(features, 128).cpu().long().t()
    assert torch.equal(got.view(128, features).cpu(), want.float())


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,offset", [((2, 10, 56, 56, 64), 0), ((3, 5, 7, 9, 3), 0), ((2, 4, 8, 8, 16), 1)])
def test_quantize_kernel_equals_plain(torch, dtype, dynamic, shape, offset):
    """The quantize pass == its plain version bit for bit, static with
    codes that saturate and dynamic at the tensor's own scale, vector and
    single-element paths (a length not a multiple of 8, an input off
    16-byte alignment); one launch counted per call."""
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.int8_conv import (
        quantize_int8,
        quantize_int8_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(3)
    dt = getattr(torch, dtype)
    n = math.prod(shape)
    x = torch.empty(n + offset, dtype=dt, device="cuda")[offset:].view(shape)
    x.copy_(torch.randn(shape, device="cuda", generator=gen) * 3.0)
    if dynamic:
        scalar = x.abs().amax().float().clamp_min(1e-30) / 127.0
    else:
        scalar = 1.0 / (torch.tensor(2.5, device="cuda") / 127.0)  # |x| > 2.5 saturates
    before = quantize_int8.launches
    got = quantize_int8(x, scalar, dynamic)
    torch.cuda.synchronize()
    assert quantize_int8.launches == before + 1
    ref = quantize_int8_reference(x, scalar, dynamic)
    assert got.dtype == torch.int8 and torch.equal(got, ref)
    assert int(got.abs().max()) == 127


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,offset", [((2, 4, 9, 9, 12), 0), ((3, 5, 7, 9, 8), 1), ((2, 3, 5, 5, 3), 0)])
def test_quantize_kernel_widens_pixels_equals_plain(torch, dtype, dynamic, shape, offset):
    """The quantize pass widening each pixel to the int8 conv's
    (`int8_input_channels`: 12 and 8 → 16, 3 stays) == its plain version
    bit for bit, on an aligned and a misaligned input; one launch."""
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.int8_conv import (
        int8_input_channels,
        quantize_int8,
        quantize_int8_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.empty(math.prod(shape) + offset, dtype=getattr(torch, dtype), device="cuda")[offset:].view(shape)
    x.copy_(torch.randn(shape, device="cuda", generator=gen) * 3.0)
    scalar = x.abs().amax().float().clamp_min(1e-30) / 127.0 if dynamic else 127.0 / torch.tensor(2.5, device="cuda")
    cp = int8_input_channels(shape[-1])
    before = quantize_int8.launches
    got = quantize_int8(x, scalar, dynamic, cp)
    torch.cuda.synchronize()
    assert quantize_int8.launches == before + 1 and got.shape == (*shape[:-1], cp)
    assert torch.equal(got, quantize_int8_reference(x, scalar, dynamic, cp))


def test_uncalibrated_static_conv_on_card_equals_cpu(torch):
    """A static conv with act_absmax = 0 (never calibrated): inv = 1e30, the
    codes saturate and the dequantize multiplies by 0, on the card as on the
    CPU, without raising."""
    from crowded_scenes_ensemble_classification_tpu_torch.models.common import (
        static_quant_conv_general,
        weight_qparams,
    )

    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 4, 9, 9, 24, generator=gen)
    k8, sw = weight_qparams(torch.randn(32, 24, 3, 3, 3, generator=gen))
    act_scale = torch.zeros(())
    ref = static_quant_conv_general(x, k8, sw, act_scale, (1, 1, 1), "SAME")
    got = static_quant_conv_general(x.cuda(), k8.cuda(), sw.cuda(), act_scale.cuda(), (1, 1, 1), "SAME")
    assert torch.equal(got.cpu(), ref) and not ref.any()


def test_int8_kernels_reject_what_they_do_not_take(torch):
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.int8_conv import (
        int8_conv3d,
        pack_int8_weights,
        quantize_int8,
    )

    x8 = torch.zeros(1, 2, 4, 4, 8, dtype=torch.int8, device="cuda")
    wp = pack_int8_weights(torch.zeros(16, 8, 1, 1, 1, dtype=torch.int8, device="cuda"))
    scale = torch.ones(16, device="cuda")
    with pytest.raises(TypeError):
        int8_conv3d(x8.float(), wp, scale, None, (1, 1, 1), (1, 1, 1), _V)
    with pytest.raises(ValueError):
        int8_conv3d(x8, wp, scale, None, (3, 3, 3), (1, 1, 1), _V)  # wp packed for a 1³ kernel
    with pytest.raises(ValueError):
        int8_conv3d(x8.transpose(2, 3), wp, scale, None, (1, 1, 1), (1, 1, 1), _V)
    with pytest.raises(TypeError):
        quantize_int8(x8, torch.ones((), device="cuda"))
    with pytest.raises(TypeError):
        quantize_int8(x8.float(), torch.ones(()))  # the scalar on the CPU


@pytest.mark.parametrize("model_type", ["I3D", "C3D", "R3D_18", "TWOSTREAM_I3D"])
def test_static_family_kernels_equal_plain_on_card(torch, no_tf32, model_type):
    """A small static-int8 model of each family (f32, calibrated on one
    batch on the CPU and baked) on the card: through the kernels, one int8
    conv launch and one quantize launch per conv, and logits equal to the
    same model on the card with the two kernels' plain versions in their
    place.  (Against the CPU it agrees within 1.3e-7 in probability for
    I3D, TwoStream and C3D, but not R3D-18 at width 0.125: cuDNN's affine
    BatchNorm rounds apart from the CPU's, and the few int8 codes that
    cross a rounding boundary move that 8-channel net's probabilities by
    0.012.  chip_smoke.py holds a static I3D to the CPU.)"""
    from unittest import mock

    import crowded_scenes_ensemble_classification_tpu_torch.models.common as common_mod
    from crowded_scenes_ensemble_classification_tpu_torch.models.quantize import (
        calibrate,
        quant_sites,
        quantize_variables,
        set_quant_mode,
    )
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.int8_conv import (
        int8_conv3d,
        int8_conv3d_reference,
        quantize_int8,
        quantize_int8_reference,
        unpack_int8_weights,
    )

    def plain_conv(x8, wp, scale, bias, kernel, strides, pads):
        k8 = unpack_int8_weights(wp, scale.shape[0], kernel, x8.shape[-1])
        return int8_conv3d_reference(x8, k8, scale, bias, strides, pads)

    gen = torch.Generator().manual_seed(9)
    module = _small_family(torch, model_type, gen, quant="calib")
    shapes = [(2, 16, 32, 32, 3)] + ([(2, 16, 32, 32, 2)] if model_type == "TWOSTREAM_I3D" else [])
    x = tuple(torch.rand(s, generator=gen) for s in shapes)
    set_quant_mode(quantize_variables(calibrate(module, [x])), "static")
    card, xc = module.cuda(), tuple(t.cuda() for t in x)
    with torch.inference_mode():
        before = (int8_conv3d.launches, quantize_int8.launches)
        got = card(*xc)
        launched = (int8_conv3d.launches - before[0], quantize_int8.launches - before[1])
        with mock.patch.object(common_mod, "int8_conv3d", plain_conv), \
                mock.patch.object(common_mod, "quantize_int8", quantize_int8_reference):
            ref = card(*xc)
    sites = len(quant_sites(card))
    assert launched == (sites, sites) and (int8_conv3d.launches, quantize_int8.launches) == tuple(
        b + n for b, n in zip(before, launched))
    assert torch.equal(got, ref)


def test_static_member_export_on_card_equals_eager(torch, no_tf32, tmp_path):
    """A small prestaged static-int8 I3D (f32, calibrated on the card by
    `calibrate_members` and baked) exported on the card with shared
    staging: the saved and loaded artifact calls the int8 kernels (one
    conv and one quantize launch a site) and its probabilities equal the
    eager `make_member_forward`'s exactly."""
    import numpy as np

    from crowded_scenes_ensemble_classification_tpu_torch.core.config import ClipSpec
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.members import (
        calibrate_members,
        make_member_forward,
    )
    from crowded_scenes_ensemble_classification_tpu_torch.models.quantize import quant_sites
    from crowded_scenes_ensemble_classification_tpu_torch.models.registry import ModelBundle
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.int8_conv import int8_conv3d, quantize_int8
    from crowded_scenes_ensemble_classification_tpu_torch.serving import (
        export_ensemble,
        load_serving_artifact,
        save_serving_artifact,
        serving_batch_example,
    )

    gen = torch.Generator().manual_seed(11)
    module = _small_family(torch, "I3D", gen, prestaged=True, quant="calib").cuda()
    rng = np.random.default_rng(12)
    calib, batch = ({"rgb": torch.from_numpy(rng.integers(0, 256, (2, 16, 32, 32, 3), dtype=np.uint8)).cuda()}
                    for _ in range(2))
    (module,) = calibrate_members([module], [calib], (32, 32), num_batches=1, input_scale=1 / 255)
    eager = make_member_forward([module], (32, 32), share_stem_staging=True, input_scale=1 / 255)(batch)
    bundle = ModelBundle("I3D", module, ClipSpec(16, 32, 32), 11, False)
    program = export_ensemble([bundle], serving_batch_example(bundle, 2), input_scale=1 / 255,
                              share_stem_staging=True)
    serve, meta = load_serving_artifact(save_serving_artifact(str(tmp_path / "s.zip"), program, {}))
    assert meta["device"] == "cuda"
    before = (int8_conv3d.launches, quantize_int8.launches)
    out = serve(batch)
    torch.cuda.synchronize()
    sites = len(quant_sites(module))
    assert (int8_conv3d.launches - before[0], quantize_int8.launches - before[1]) == (sites, sites)
    assert torch.equal(out["probs"], eager)


def test_offline_augment_video_file_on_card_equals_plain_route(torch, tmp_path):
    """`augment_video_file` on the card (the noise kernel, one launch) writes
    the frames of the plain route: the same decisions, crop, flip and resize
    on the card, then `salt_pepper`'s plain version, on a copy whose salt and
    pepper gates are on (its frames differ from the noiseless ones); the two
    mp4 files decode to the same frames, and the copy re-runs bit-equal."""
    import numpy as np

    pytest.importorskip("cv2")
    from crowded_scenes_ensemble_classification_tpu_torch.data import augment_offline, video_io
    from crowded_scenes_ensemble_classification_tpu_torch.ops.augment import NOISE_RATIO, crop_flip_resize, draw_decisions
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.noise import salt_pepper, salt_pepper_plain

    clip = np.random.default_rng(0).integers(0, 256, (12, 120, 160, 3), dtype=np.uint8)
    src = str(tmp_path / "src.mp4")
    video_io.write_video(src, clip)
    decoded = augment_offline._load_full_clip(src)
    for clip_index in range(16):  # the first copy whose noise gates are on
        seed = augment_offline.offline_seed(0, 1, clip_index, 0)
        d = draw_decisions(torch.Generator().manual_seed(seed), 1, decoded.shape[1:3],
                           augment_offline.OFFLINE_AUGMENT_P)
        if bool(d.salt[0] and d.pepper[0]):
            break
    else:
        pytest.fail("no copy of the first 16 has both noise gates on")
    d = d.to("cuda")
    x = torch.from_numpy(decoded).cuda()[None]
    resized = crop_flip_resize(x, augment_offline.OFFLINE_OUT_HW, d)
    plain = salt_pepper_plain(resized, d.seed, d.salt, d.pepper, NOISE_RATIO)[0].to(torch.uint8).cpu().numpy()
    before = salt_pepper.launches
    out = augment_offline.augment_video_file(src, str(tmp_path / "kernel.mp4"), seed, device="cuda")
    assert salt_pepper.launches == before + 1
    frames = augment_offline.augment_clip(decoded, seed, "cuda")
    assert frames.shape == (12, 224, 224, 3) and np.array_equal(frames, plain)
    assert (frames != resized[0].to(torch.uint8).cpu().numpy()).any()  # the noise wrote pixels
    assert np.array_equal(frames, augment_offline.augment_clip(decoded, seed, "cuda"))
    video_io.write_video(str(tmp_path / "plain.mp4"), plain)
    assert np.array_equal(video_io.decode_clip(out, 12, None), video_io.decode_clip(str(tmp_path / "plain.mp4"), 12,
                                                                                        None))

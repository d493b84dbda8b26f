"""Parity of the PyTorch port's I3D, ensemble forward and main-path slice
with the JAX package, on the CPU in float32.

Variables are drawn with numpy into the flax tree (shapes from
`jax.eval_shape` of the flax init, which compiles nothing), converted with
`models/convert.py`, and fed to both sides with the same numpy inputs.
BatchNorm statistics are drawn away from (0, 1) so every layer matters.
torch and the port are imported by fixtures, not at collection
(tests/torch_port_memory.py).
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crowded_scenes_ensemble_classification_tpu.models import common as jcommon
from crowded_scenes_ensemble_classification_tpu.models import i3d as ji3d
from torch_port_memory import release_heap_after_module, torch  # noqa: F401 (fixtures)

PORT = "crowded_scenes_ensemble_classification_tpu_torch"


@pytest.fixture(scope="module")
def tcommon(torch):
    return importlib.import_module(f"{PORT}.models.common")


@pytest.fixture(scope="module")
def ti3d(torch):
    return importlib.import_module(f"{PORT}.models.i3d")


def random_flax_variables(module, x_shape, seed):
    """numpy-seeded variables with the flax init's tree and shapes."""
    shapes = jax.eval_shape(
        lambda x: module.init(jax.random.key(0), x, train=False),
        jax.ShapeDtypeStruct(x_shape, jnp.float32),
    )
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            v = rng.normal(0.0, 1.0 / math.sqrt(math.prod(s.shape[:-1])), s.shape)
        elif name in ("bias", "mean"):
            v = rng.normal(0.0, 0.1, s.shape)
        elif name == "var":
            # < 1 on average: BN then lifts what ReLU halves, so logits stay O(1)
            v = rng.uniform(0.3, 0.7, s.shape)
        else:
            raise KeyError(name)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def port_module(module, variables):
    """The port's module on the converted flax variables, in eval mode."""
    from crowded_scenes_ensemble_classification_tpu_torch.models.convert import (
        i3d_state_dict_from_flax,
    )

    module.load_state_dict(i3d_state_dict_from_flax(variables), strict=True)
    return module.eval()



@pytest.mark.parametrize(
    "kernel,strides,shape",
    [
        ((1, 1, 1), (1, 1, 1), (2, 3, 5, 5, 8)),
        ((3, 3, 3), (1, 1, 1), (1, 5, 7, 6, 8)),
        ((7, 7, 7), (2, 2, 2), (1, 8, 10, 9, 3)),  # asymmetric (2,3) and odd (3,3) pads
    ],
)
def test_convbn_matches_flax(torch, tcommon, kernel, strides, shape):
    """TF-SAME ConvBN, symmetric and asymmetric pads.  atol 1e-5: f32 sums
    of at most 1029 products in another order."""
    flax_mod = jcommon.ConvBN(16, kernel, strides)
    v = random_flax_variables(flax_mod, shape, seed=1)
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    ref = np.asarray(flax_mod.apply(v, x, train=False))
    port = port_module(tcommon.ConvBN(shape[-1], 16, kernel, strides), v)
    with torch.no_grad():
        got = tcommon.to_nthwc(port(tcommon.to_ncdhw(torch.from_numpy(x)))).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 4, 6, 6, 32), (1, 3, 5, 7, 32)])
def test_inception_block_matches_flax(torch, tcommon, ti3d, shape):
    """One Mixed block, pool branch through the max-pool wrapper's plain
    version.  atol 1e-5 as for ConvBN."""
    spec = (8, 8, 16, 4, 8, 8)
    flax_mod = ji3d.InceptionBlock(spec)
    v = random_flax_variables(flax_mod, shape, seed=3)
    x = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    ref = np.asarray(flax_mod.apply(v, x, train=False))
    port = port_module(ti3d.InceptionBlock(shape[-1], spec), v)
    with torch.no_grad():
        got = tcommon.to_nthwc(port(tcommon.to_ncdhw(torch.from_numpy(x)))).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_prestaged_stem_matches_flax(torch, tcommon):
    """s2d staging + prestaged stem == flax's on the same staging.  atol
    1e-5: sums of 1344 f32 products in another order."""
    x = np.random.default_rng(5).normal(size=(2, 6, 16, 12, 3)).astype(np.float32)
    xs_j = np.asarray(jcommon.s2d_stem_stage(jnp.asarray(x)))
    xs_t = tcommon.s2d_stem_stage(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(xs_t, xs_j)
    flax_mod = jcommon.PrestagedS2DStemConvBN(16)
    v = random_flax_variables(flax_mod, xs_j.shape, seed=6)
    ref = np.asarray(flax_mod.apply(v, xs_j, train=False))
    port = port_module(tcommon.PrestagedS2DStemConvBN(3, 16), v)
    with torch.no_grad():
        got = tcommon.to_nthwc(port(torch.from_numpy(xs_t))).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def i3d_pair(ti3d):
    """flax I3D and the port on one set of converted variables."""
    flax_mod = ji3d.I3D(num_classes=11)
    v = random_flax_variables(flax_mod, (1, 16, 32, 32, 3), seed=7)
    port = port_module(ti3d.I3D(11, frames=16), v)
    apply = jax.jit(lambda v, x: flax_mod.apply(v, x, train=False))
    return v, apply, port


@pytest.mark.parametrize("shape", [(2, 16, 32, 32, 3), (1, 16, 40, 40, 3)])
def test_i3d_matches_flax(torch, i3d_pair, shape):
    """Full I3D logits, rtol = atol = 1e-4: about 60 f32 layers, each summed
    in another order.  (1,16,40,40) puts Mixed_3b at 5×5 and Mixed_5b at
    2×2, so the odd-size TF-SAME pads run."""
    v, apply, port = i3d_pair
    x = np.random.default_rng(8).normal(0.0, 50.0, size=shape).astype(np.float32)
    ref = np.asarray(apply(v, x))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (shape[0], 11) and got.dtype == np.float32
    assert np.abs(ref).max() > 0.1  # logits are not vanishingly small
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_port_prestaged_matches_port_canonical(torch, tcommon, ti3d, i3d_pair):
    """Same state dict, stem run on the s2d staging vs the 7³/2 conv.
    atol 1e-5: an exact rewrite summed in another order."""
    _, _, canonical = i3d_pair
    prestaged = ti3d.I3D(11, frames=16, stem_prestaged=True)
    prestaged.load_state_dict(canonical.state_dict(), strict=True)
    prestaged.eval()
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(2, 16, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        a = canonical(x)
        b = prestaged(tcommon.s2d_stem_stage(x))
    torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "variant,stem_class",
    [({"stem_impl": "pallas"}, "PallasStemConvBN"), ({"s2d_stem": True}, "S2DStemConvBN")],
    ids=["pallas", "s2d"],
)
def test_i3d_stem_variants_match_flax(torch, ti3d, i3d_pair, variant, stem_class):
    """I3D(stem_impl='pallas') (the stem kernel's plain version on the CPU)
    and I3D(s2d_stem=True) on the same converted variables against the
    canonical flax forward, rtol = atol = 1e-4 as for the canonical port.
    The flax stems share ConvBN's tree, so the canonical apply is their
    reference (JAX's Pallas stem runs only on a TPU outside interpret mode)."""
    v, apply, _ = i3d_pair
    port = port_module(ti3d.I3D(11, frames=16, **variant), v)
    assert type(port.trunk.Conv3d_1a_7x7).__name__ == stem_class
    x = np.random.default_rng(8).normal(0.0, 50.0, size=(2, 16, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(apply(v, x))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(1, 5, 16, 16, 3), (1, 6, 15, 16, 3), (1, 6, 16, 17, 3)],
                         ids=["odd_t", "odd_h", "odd_w"])
@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_kernel_stem_raises_where_the_kernel_does_not_take_the_clips(torch, tcommon, shape, training):
    """PallasStemConvBN always calls the stem kernel's op: clips with an
    odd T, H or W raise through its checks, in eval and in train mode,
    instead of running the canonical conv."""
    stem = tcommon.PallasStemConvBN(3, 16, generator=torch.Generator().manual_seed(0)).train(training)
    with torch.no_grad(), pytest.raises(ValueError, match="must be even"):
        stem(tcommon.to_ncdhw(torch.zeros(shape)))


def test_build_model_round_trips_flax_state_dict(torch):
    """build_model("I3D", device="cpu") builds the canonical 20-frame I3D in
    eval mode; a converted flax state dict loads strictly and reads back
    unchanged; bf16 holds conv and dense weights in bf16 (channels_last_3d
    convs) and BN in f32; predict_proba gives rows summing to 1."""
    from crowded_scenes_ensemble_classification_tpu_torch.models import build_model, predict_proba
    from crowded_scenes_ensemble_classification_tpu_torch.models.convert import (
        i3d_state_dict_from_flax,
    )

    sd = i3d_state_dict_from_flax(random_flax_variables(ji3d.I3D(num_classes=11), (1, 20, 32, 32, 3), seed=30))
    bundle = build_model("I3D", device="cpu", stem_impl="pallas")
    assert (bundle.model_type, bundle.num_classes, bundle.two_stream) == ("I3D", 11, False)
    assert bundle.clip.rgb_shape == (20, 224, 224, 3) and bundle.device.type == "cpu"
    assert not bundle.module.training
    dummy = bundle.dummy_batch(2)["rgb"]
    assert dummy.shape == (2, 20, 224, 224, 3) and dummy.device.type == "cpu" and not dummy.any()
    bundle.module.load_state_dict(sd, strict=True)
    back = bundle.module.state_dict()
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)

    low = build_model("I3D", dtype=torch.bfloat16, device="cpu")
    low.module.load_state_dict(sd, strict=True)
    stem = low.module.trunk.Conv3d_1a_7x7
    assert stem.conv.weight.dtype == low.module.predictions.weight.dtype == torch.bfloat16
    assert stem.conv.weight.is_contiguous(memory_format=torch.channels_last_3d)
    assert stem.bn.running_var.dtype == torch.float32
    x = np.random.default_rng(31).normal(0.0, 1.0, (2, 20, 32, 32, 3)).astype(np.float32)
    probs = predict_proba(bundle, {"rgb": torch.from_numpy(x)})
    assert probs.shape == (2, 11)
    torch.testing.assert_close(probs.sum(-1), torch.ones(2))


def test_build_model_runs_on_the_card_unless_told(torch, monkeypatch):
    """With no device named, build_model needs a card and raises without
    one, for every family; on the CPU, C3D builds trainable (f32 master
    weights computing in bf16, in train mode); an unknown family raises."""
    from crowded_scenes_ensemble_classification_tpu_torch.models import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("I3D")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("C3D", width=0.125)
    c3d = build_model("C3D", dtype=torch.bfloat16, device="cpu", trainable=True, width=0.125)
    assert c3d.trainable and c3d.module.training and c3d.module.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in c3d.module.parameters())
    with pytest.raises(ValueError):
        build_model("I3D_XL", device="cpu")


def test_port_init_matches_flax_scale(torch, ti3d):
    """The port's own init is flax's lecun-normal: kernel std ≈ 1/sqrt(fan_in)
    (within 5% for the 1024×11 dense and a Mixed_5c conv); BN mean 0,
    var 1, bias 0; the frozen BN weight is 1."""
    m = ti3d.I3D(11, frames=20, generator=torch.Generator().manual_seed(0))
    w = m.trunk.Mixed_5c.b1_1x1.conv.weight
    assert abs(w.std().item() * math.sqrt(832) - 1.0) < 0.05
    d = m.predictions.weight
    assert d.shape == (11, 2048)
    assert abs(d.std().item() * math.sqrt(2048) - 1.0) < 0.05
    assert d.abs().max().item() <= 2.0 / math.sqrt(2048) / 0.87962566103423978 + 1e-6
    bn = m.trunk.Mixed_5c.b1_1x1.bn
    assert torch.equal(bn.running_mean, torch.zeros(192))
    assert torch.equal(bn.running_var, torch.ones(192))
    assert torch.equal(bn.weight, torch.ones(192)) and not bn.weight.requires_grad


# ----------------------------------------------------------------------
# Ensemble forward and the main-path slice
# ----------------------------------------------------------------------

FRAMES, STAGING, OUT, BATCH, MEMBERS = 16, 80, 32, 2, 2


@pytest.fixture(scope="module")
def members_pair(ti3d):
    """MEMBERS flax variable sets, a jitted flax prestaged forward, and the
    port's prestaged members on the converted variables."""
    flax_mod = ji3d.I3D(num_classes=11, stem_prestaged=True)
    staged = (1, FRAMES, OUT // 2 + 3, OUT // 2 + 3, 12)
    vs = [random_flax_variables(flax_mod, staged, seed=20 + i) for i in range(MEMBERS)]
    for v in vs:
        # the step feeds 0-255 pixels, which drive these logits to ~360;
        # a 0.01 dense scale keeps them O(1), so the softmax is not saturated
        v["params"]["predictions"]["kernel"] *= 0.01
    apply = jax.jit(lambda v, xs: jax.nn.softmax(flax_mod.apply(v, xs, train=False), -1))
    port = [port_module(ti3d.I3D(11, frames=FRAMES, stem_prestaged=True), v) for v in vs]
    return vs, apply, port


def test_slice_matches_jax(torch, members_pair):
    """The whole step: I420 rows → decode → augment (noise gates off) →
    s2d staging → 2 members → softmax → SUM fusion → argmax, JAX side
    built from its own functions in the order of its benchmark step.
    Decisions are the JAX key splits' own.  (M,B,C) probabilities to
    atol 1e-5; fused argmax equal."""
    from crowded_scenes_ensemble_classification_tpu.data.wire_format import (
        i420_to_bgr_u8 as j_i420,
    )
    from crowded_scenes_ensemble_classification_tpu.ops.augment import (
        augment_crop_decisions,
        crowd11_augment,
    )
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.pipeline import (
        ensemble_step_from_decisions,
    )
    from crowded_scenes_ensemble_classification_tpu_torch.ops.augment import (
        AugmentDecisions,
    )

    vs, apply, port = members_pair
    p = 0.75
    rows = np.random.default_rng(11).integers(
        0, 256, (BATCH, FRAMES * STAGING * STAGING * 3 // 2), dtype=np.uint8
    )
    key = jax.random.key(5)
    keys = jax.random.split(key, BATCH)
    batch = jax.vmap(lambda f: j_i420(f, FRAMES, STAGING, STAGING))(rows)
    x = jax.vmap(
        lambda c, k: crowd11_augment(c, k, (OUT, OUT), p, apply_noise=False)
    )(batch.astype(jnp.float32), keys)
    xs = jcommon.s2d_stem_stage(x)
    ref_probs = np.stack([np.asarray(apply(v, xs)) for v in vs])
    ref_fused = np.argmax(ref_probs.sum(0), -1)

    do_crop, y0, x0 = augment_crop_decisions(key, BATCH, (STAGING, STAGING), p)
    flip = np.array([bool(jax.random.bernoulli(jax.random.split(k, 7)[2], p)) for k in keys])
    off = torch.zeros(BATCH, dtype=torch.bool)
    decisions = AugmentDecisions(
        torch.tensor(do_crop), torch.tensor(y0), torch.tensor(x0),
        torch.tensor(flip), off, off, seed=123,
    )
    probs, fused = ensemble_step_from_decisions(
        port, torch.from_numpy(rows), decisions, FRAMES, STAGING, (OUT, OUT)
    )
    assert probs.shape == (MEMBERS, BATCH, 11)
    np.testing.assert_allclose(probs.numpy(), ref_probs, atol=1e-5)
    np.testing.assert_array_equal(fused.numpy(), ref_fused)


def test_member_probabilities_over_batches(torch, members_pair):
    """member_probabilities resizes, scales, runs the shared-stem forward
    per batch and keeps the valid rows, in order; each member equals the
    flax prestaged forward on the same staging (atol 1e-5)."""
    from crowded_scenes_ensemble_classification_tpu.ops.augment import (
        identity_resize_batch,
    )
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.members import (
        member_probabilities,
    )

    vs, apply, port = members_pair
    rng = np.random.default_rng(12)
    batches = [
        {"rgb": rng.integers(0, 256, (2, FRAMES, 40, 40, 3)).astype(np.uint8),
         "valid": np.array([True, False])},
        {"rgb": rng.integers(0, 256, (2, FRAMES, 40, 40, 3)).astype(np.uint8)},
    ]
    got = member_probabilities(port, batches, (OUT, OUT), input_scale=1 / 255.0)
    assert got.shape == (MEMBERS, 3, 11)
    rgb = np.concatenate([batches[0]["rgb"][:1], batches[1]["rgb"]])
    x = identity_resize_batch(jnp.asarray(rgb, jnp.float32), (OUT, OUT)) * (1 / 255.0)
    xs = jcommon.s2d_stem_stage(x)
    ref = np.stack([np.asarray(apply(v, xs)) for v in vs])
    np.testing.assert_allclose(got, ref, atol=1e-5)

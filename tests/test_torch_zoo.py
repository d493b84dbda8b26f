"""Parity of the PyTorch port's model zoo (C3D, R3D-18…152, TwoStream-I3D),
its member forwards and the heterogeneous ensemble step with the JAX
package, on the CPU in float32.

Variables are drawn with numpy into the flax tree (shapes from
`jax.eval_shape` of the flax init, which compiles nothing), converted with
`models/convert.py`, and fed to both sides with the same numpy inputs.
BatchNorm statistics and gammas are drawn away from (0, 1) so every layer
matters.  Each JAX forward is compiled once per module (module-scoped
fixtures); the deep R3D presets are checked by structure only.  torch and
the port are imported by fixtures, not at collection
(tests/torch_port_memory.py).
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi

from crowded_scenes_ensemble_classification_tpu.core import config as jconfig
from crowded_scenes_ensemble_classification_tpu.flow import farneback as jfb
from crowded_scenes_ensemble_classification_tpu.models import c3d as jc3d
from crowded_scenes_ensemble_classification_tpu.models import common as jcommon
from crowded_scenes_ensemble_classification_tpu.models import i3d as ji3d
from crowded_scenes_ensemble_classification_tpu.models import r3d as jr3d
from crowded_scenes_ensemble_classification_tpu.models import two_stream_i3d as jts
from torch_port_memory import release_heap_after_module, torch  # noqa: F401 (fixtures)

PORT = "crowded_scenes_ensemble_classification_tpu_torch"
CLASSES = 11
WIDTH = 0.125


@pytest.fixture(scope="module")
def port(torch):
    """The port's modules by short name."""
    names = ("core.config", "models.common", "models.c3d", "models.i3d", "models.r3d", "models.two_stream_i3d",
             "models.convert", "models.registry", "ensemble.members", "ensemble.pipeline")
    return {n.split(".")[-1]: importlib.import_module(f"{PORT}.{n}") for n in names}


def flax_shapes(module, *x_shapes):
    return jax.eval_shape(
        lambda *xs: module.init(jax.random.key(0), *xs, train=False),
        *[jax.ShapeDtypeStruct(s, jnp.float32) for s in x_shapes],
    )


def flax_forward(module, shapes, *x_shapes):
    """`module.apply(v, *x, train=False)` compiled for these shapes at XLA's
    backend optimization level 0: the same computation, compiled in about
    half the time (which dominates at these sizes)."""
    return jax.jit(lambda v, *xs: module.apply(v, *xs, train=False)).lower(
        shapes, *[jax.ShapeDtypeStruct(s, jnp.float32) for s in x_shapes]
    ).compile({"xla_backend_optimization_level": 0})


def random_flax_variables(module, x_shapes, seed):
    """numpy-seeded variables with the flax init's tree and shapes."""
    return fill_variables(flax_shapes(module, *x_shapes), seed)


def fill_variables(shapes, seed):
    """numpy-seeded variables of a `flax_shapes` tree."""
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
        elif name == "scale":
            v = rng.uniform(0.5, 1.5, s.shape)
        else:
            raise KeyError(name)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def load(make, model_type, variables, port):
    """The port's module `make()` on the converted flax variables, in eval
    mode.  It is built on the meta device, so no random init is drawn only
    to be overwritten."""
    import torch

    with torch.device("meta"):
        module = make()
    module.load_state_dict(port["convert"].state_dict_from_flax(model_type, variables), strict=True, assign=True)
    return module.eval()


# ----------------------------------------------------------------------
# Configuration and registry
# ----------------------------------------------------------------------


def test_config_matches_jax(port):
    """All eight clip specs, the model types, flow statuses and weighting
    schemes equal the JAX package's; an unknown type raises ValueError."""
    cfg = port["config"]
    assert cfg.MODEL_TYPES == jconfig.MODEL_TYPES
    assert cfg.OPTICAL_FLOW_STATUSES == jconfig.OPTICAL_FLOW_STATUSES
    assert cfg.WEIGHTING_SCHEMES == jconfig.WEIGHTING_SCHEMES
    for mt in jconfig.MODEL_TYPES:
        j, t = jconfig.clip_spec(mt), cfg.clip_spec(mt)
        assert (t.rgb_shape, t.flow_shape) == (j.rgb_shape, j.flow_shape), mt
    with pytest.raises(ValueError, match="Unknown model_type"):
        cfg.clip_spec("I3D_XL")


@pytest.mark.parametrize("model_type", jconfig.MODEL_TYPES)
def test_build_model_resolves_every_type(torch, port, model_type):
    """build_model builds each of the eight types in eval mode (C3D and R3D
    at width 0.125 on the CPU from a CPU generator; the full-width I3D
    family on the meta device, which draws no weights): clip geometry,
    two-stream flag, dummy batch keys and shapes, bf16 conv/dense weights
    with f32 BN, and a summary whose total counts every parameter of the
    reference.  Built trainable (every type), the same model keeps f32
    master weights, channels_last_3d convs and the two-stream flag, in train
    mode, computing in bf16."""
    reg = port["registry"]
    small = model_type.startswith(("C3D", "R3D"))
    kw = {"width": WIDTH} if small else {}
    where = {"device": "cpu", "generator": torch.Generator().manual_seed(0)} if small else {"device": "meta"}
    bundle = reg.build_model(model_type, dtype=torch.bfloat16, **where, **kw)
    assert bundle.device.type == where["device"]
    spec = jconfig.clip_spec(model_type)
    assert bundle.clip.rgb_shape == spec.rgb_shape and not bundle.module.training
    assert bundle.two_stream == (model_type == "TWOSTREAM_I3D")
    batch = bundle.dummy_batch(2)
    assert sorted(batch) == (["flow", "rgb"] if bundle.two_stream else ["rgb"])
    assert batch["rgb"].shape == (2,) + spec.rgb_shape
    if bundle.two_stream:
        assert batch["flow"].shape == (2,) + spec.flow_shape
    convs = [m for m in bundle.module.modules() if isinstance(m, torch.nn.Conv3d)]
    bns = [m for m in bundle.module.modules() if isinstance(m, torch.nn.BatchNorm3d)]
    assert convs and all(c.weight.dtype == torch.bfloat16 for c in convs)
    assert all(b.running_var.dtype == torch.float32 for b in bns)
    frozen = sum(b.weight.numel() for b in bns if not b.weight.requires_grad)
    total = sum(p.numel() for p in bundle.module.parameters()) - frozen
    assert port["registry"].summarize(bundle).splitlines()[-1 - bool(bns)] == f"total params: {total:,}"
    trainable = reg.build_model(model_type, dtype=torch.bfloat16, trainable=True, **where, **kw)
    assert trainable.trainable and trainable.module.training and trainable.two_stream == bundle.two_stream
    assert trainable.module.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in trainable.module.parameters())
    assert all(c.weight.is_contiguous(memory_format=torch.channels_last_3d)
               for c in trainable.module.modules() if isinstance(c, torch.nn.Conv3d))


def test_converters_refuse_foreign_keys(port):
    """Each family's converter refuses a key its family does not have."""
    conv = port["convert"]
    k = np.zeros((1, 1, 1, 3, 8), np.float32)
    with pytest.raises(KeyError, match="I3D"):  # I3D's BN has no gamma
        conv.i3d_state_dict_from_flax({"params": {"c": {"bn": {"scale": np.ones(8), "bias": np.ones(8)}}}})
    with pytest.raises(KeyError, match="I3D"):  # nor do its convs carry a bias
        conv.i3d_state_dict_from_flax({"params": {"b": {"conv": {"kernel": k, "bias": np.ones(8)}}}})
    with pytest.raises(KeyError, match="C3D"):
        conv.c3d_state_dict_from_flax({"params": {"conv1": {"kernel": k}}, "batch_stats": {"bn": {"mean": 0}}})
    with pytest.raises(KeyError, match="TWOSTREAM_I3D"):
        conv.two_stream_state_dict_from_flax({"params": {"trunk": {"c": {"conv": {"kernel": k}}}}})
    with pytest.raises(KeyError, match="R3D"):
        conv.r3d_state_dict_from_flax({"params": {"conv1": {"kernel": k, "weight": k}}})


# ----------------------------------------------------------------------
# Building blocks
# ----------------------------------------------------------------------


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_bn_relu_matches_flax(torch, port, training):
    """BNRelu is full-affine: gamma loads from flax's `scale` and is a
    trained parameter; eval on the running statistics and train on the
    biased batch statistics (running stats updated with momentum 0.99)
    match flax at 1e-5."""
    shape = (2, 3, 5, 4, 8)
    flax_mod = jcommon.BNRelu()
    v = random_flax_variables(flax_mod, [shape], seed=1)
    x = np.random.default_rng(2).normal(1.0, 2.0, size=shape).astype(np.float32)
    ref, mut = flax_mod.apply(v, x, train=training, mutable=["batch_stats"])
    m = port["common"].BNRelu(8)
    m.load_state_dict(port["convert"].r3d_state_dict_from_flax(v), strict=True)
    assert m.bn.weight.requires_grad
    tc = port["common"]
    got = tc.to_nthwc(m.train(training)(tc.to_ncdhw(torch.from_numpy(x)))).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m.bn.running_var.numpy(), np.asarray(mut["batch_stats"]["bn"]["var"]), rtol=1e-5)


@pytest.mark.parametrize("window", [(1, 2, 2), (2, 2, 2)])
def test_valid_max_pool_matches_flax(torch, port, window):
    """VALID pools drop what does not fit, odd sizes included."""
    x = np.random.default_rng(3).normal(size=(2, 5, 7, 9, 4)).astype(np.float32)
    ref = np.asarray(jcommon.max_pool_3d(jnp.asarray(x), window, window, "VALID"))
    tc = port["common"]
    got = tc.to_nthwc(tc.max_pool_3d(tc.to_ncdhw(torch.from_numpy(x)), window, window, padding="VALID")).numpy()
    np.testing.assert_array_equal(got, ref)


# ----------------------------------------------------------------------
# Whole families against flax
# ----------------------------------------------------------------------

RGB = (2, 16, 32, 32, 3)


# name → (flax module, port module from the port's modules, model type, input shape)
FAMILIES = {
    "c3d": (jc3d.C3D(num_classes=CLASSES, width=WIDTH), lambda p: p["c3d"].C3D(CLASSES, WIDTH, clip_thw=RGB[1:4]),
            "C3D", RGB),
    "r3d18": (jr3d.R3D(num_classes=CLASSES, depth=18, width=WIDTH), lambda p: p["r3d"].R3D(CLASSES, 18, WIDTH),
              "R3D_18", RGB),
    "r3d50": (jr3d.R3D(num_classes=CLASSES, depth=50, width=WIDTH), lambda p: p["r3d"].R3D(CLASSES, 50, WIDTH),
              "R3D_50", (1,) + RGB[1:]),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_matches_flax(torch, port, family):
    """C3D (width 0.125), R3D-18 (basic blocks) and R3D-50 (bottlenecks)
    logits against flax, rtol = atol = 1e-4 (the I3D bar,
    test_torch_models.py): every layer in f32 in another order."""
    flax_mod, make, model_type, shape = FAMILIES[family]
    shapes = flax_shapes(flax_mod, shape)
    v = fill_variables(shapes, seed=10)
    x = np.random.default_rng(11).normal(0.0, 50.0, size=shape).astype(np.float32)
    ref = np.asarray(flax_forward(flax_mod, shapes, shape)(v, x))
    with torch.no_grad():
        got = load(lambda: make(port), model_type, v, port)(torch.from_numpy(x)).numpy()
    assert got.shape == (shape[0], CLASSES) and np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("depth", [34, 101, 152])
def test_deep_r3d_matches_flax_tree(torch, port, depth):
    """R3D-34/101/152 by structure: the converted `jax.eval_shape` tree and
    the port's state dict have the same keys and shapes."""
    shapes = flax_shapes(jr3d.R3D(num_classes=CLASSES, depth=depth, width=WIDTH), (1, 16, 32, 32, 3))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    converted = port["convert"].r3d_state_dict_from_flax(zeros)
    sd = port["r3d"].R3D(CLASSES, depth, WIDTH).state_dict()
    assert sorted(converted) == sorted(sd)
    assert {k: tuple(v.shape) for k, v in converted.items()} == {k: tuple(v.shape) for k, v in sd.items()}


TS_RGB, TS_FLOW = (1, 16, 32, 32, 3), (1, 16, 32, 32, 2)


@pytest.fixture(scope="module")
def two_stream_flax():
    """flax TwoStreamI3D at TS_RGB/TS_FLOW: its variable shapes and jitted
    forward, compiled once for this module."""
    flax_mod = jts.TwoStreamI3D(num_classes=CLASSES)
    shapes = flax_shapes(flax_mod, TS_RGB, TS_FLOW)
    return shapes, flax_forward(flax_mod, shapes, TS_RGB, TS_FLOW)


@pytest.fixture(scope="module")
def two_stream_pair(torch, port, two_stream_flax):
    """flax TwoStreamI3D and the port on one set of converted variables."""
    shapes, apply = two_stream_flax
    v = fill_variables(shapes, seed=12)
    rng = np.random.default_rng(13)
    x_rgb = rng.normal(0.0, 50.0, size=TS_RGB).astype(np.float32)
    x_flow = rng.normal(0.0, 20.0, size=TS_FLOW).astype(np.float32)
    ref = np.asarray(apply(v, x_rgb, x_flow))
    module = load(lambda: port["two_stream_i3d"].TwoStreamI3D(CLASSES, frames=16), "TWOSTREAM_I3D", v, port)
    return module, x_rgb, x_flow, ref


def test_two_stream_matches_flax(torch, two_stream_pair):
    """TwoStream-I3D logits against flax, rtol = atol = 1e-4; the flow trunk
    takes 2 channels and the head concatenates [rgb, flow]."""
    module, x_rgb, x_flow, ref = two_stream_pair
    assert module.flow_trunk.Conv3d_1a_7x7.conv.weight.shape[1] == 2
    with torch.no_grad():
        got = module(torch.from_numpy(x_rgb), torch.from_numpy(x_flow)).numpy()
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_two_stream_prestaged_matches_canonical(torch, port, two_stream_pair):
    """The same state dict with both stems on the shared s2d stagings equals
    the canonical form at atol 1e-5: an exact rewrite summed in another order."""
    module, x_rgb, x_flow, _ = two_stream_pair
    with torch.device("meta"):
        prestaged = port["two_stream_i3d"].TwoStreamI3D(CLASSES, frames=16, stem_prestaged=True)
    prestaged.load_state_dict(module.state_dict(), strict=True, assign=True)
    stage = port["common"].s2d_stem_stage
    a, b = torch.from_numpy(x_rgb), torch.from_numpy(x_flow)
    with torch.no_grad():
        torch.testing.assert_close(prestaged.eval()(stage(a), stage(b)), module(a, b), rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------
# Member forwards and the heterogeneous step
# ----------------------------------------------------------------------


class _Pipeline:
    """What the JAX member_probabilities reads: `batches(epoch)`."""

    def __init__(self, batches):
        self._batches = batches

    def batches(self, epoch):
        return iter(self._batches)


def test_member_probabilities_c3d_matches_jax(torch, port):
    """member_probabilities over two batches of uint8 clips, resized from
    40² to the members' 32², scaled by 1/255, unshared C3D members, valid
    rows kept in order: equal to the JAX function's at atol 1e-5."""
    from crowded_scenes_ensemble_classification_tpu.ensemble.members import (
        member_probabilities as j_member_probabilities,
    )
    from crowded_scenes_ensemble_classification_tpu.models.registry import ModelBundle as JBundle

    flax_mod = jc3d.C3D(num_classes=CLASSES, width=WIDTH)
    shapes = flax_shapes(flax_mod, RGB)
    vs = [fill_variables(shapes, seed=20 + i) for i in range(2)]
    rng = np.random.default_rng(21)
    batches = [
        {"rgb": rng.integers(0, 256, (2, 16, 40, 40, 3)).astype(np.uint8), "valid": np.array([True, False])},
        {"rgb": rng.integers(0, 256, (2, 16, 40, 40, 3)).astype(np.uint8), "valid": np.array([True, True])},
    ]
    bundle = JBundle("C3D", flax_mod, jconfig.ClipSpec(16, 32, 32), CLASSES, False)
    ref = j_member_probabilities(bundle, vs, _Pipeline(batches), input_scale=1 / 255.0)
    members = [load(lambda: port["c3d"].C3D(CLASSES, WIDTH, clip_thw=(16, 32, 32)), "C3D", v, port) for v in vs]
    got = port["members"].member_probabilities(members, batches, (32, 32), input_scale=1 / 255.0)
    assert got.shape == ref.shape == (2, 3, CLASSES)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def textured_frames(rng, frames, size, step, period):
    """(frames, size, size) 0-255 float32 frames of a texture periodic in
    `period` px (a blur of seeded noise, stretched), moved `step` px to the
    right each frame.  With frames·step = period, frame T−1 → frame 0 moves
    by `step` too, so the steps' rolled pairing sees one motion.  Texture
    keeps Farnebäck's 2×2 solve well conditioned (tests/test_torch_flow.py)."""
    tile = ndi.gaussian_filter(rng.random((period, period)) * 255.0, 1.5, mode="wrap")
    tile = np.clip((tile - tile.mean()) * 4.0 + 128.0, 0.0, 255.0)
    base = np.tile(tile, (-(-size // period), -(-size // period)))[:size, :size]
    return np.stack([np.roll(base, t * step, 1) for t in range(frames)]).astype(np.float32)


# Both sides take this schedule: max_disp=4 clamps nothing of these
# motions and keeps the JAX compile of the separable warp small.
FLOW_PARAMS = dict(jfb.TURBO_PARAMS, max_disp=4)


def test_prepare_member_inputs_flow(torch, port):
    """Precomputed flow is resized and scaled like rgb, as the JAX
    preprocessing does in the TVL1_precomputed mode.  Gray pairs become
    Farnebäck flow (JAX members.py:66-90): staged above 224 they are first
    resized to `reference_flow_hw` (224×223 here), below it solved as
    staged; the flow is resized to the model's 16² and, being
    displacement, not scaled by input_scale.  Against the JAX function on
    textured pairs moved 2 px, atol 1e-3 px (the flow's bound in
    tests/test_torch_flow.py) and rgb atol 1e-4 (two lerps in float32)."""
    from crowded_scenes_ensemble_classification_tpu.ensemble.members import (
        prepare_member_inputs as j_prepare,
    )

    rng = np.random.default_rng(22)
    batch = {"rgb": rng.integers(0, 256, (2, 4, 20, 24, 3)).astype(np.uint8),
             "flow": rng.integers(0, 256, (2, 4, 20, 24, 2)).astype(np.uint8)}
    ref = jax.jit(lambda b: j_prepare(b, (16, 16), True, 0.5))(batch)
    got = port["members"].prepare_member_inputs({k: torch.from_numpy(v) for k, v in batch.items()}, (16, 16),
                                                True, 0.5)
    for k in ("rgb", "flow"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-4)

    for h, w in ((226, 225), (40, 36)):  # above 224, then below it
        frames = textured_frames(rng, 3, max(h, w), 2, max(h, w) // 2)[:, :h, :w]
        gray = {"rgb": np.repeat(frames[None, :2, ..., None], 3, -1).astype(np.uint8),
                "gray": frames[None, :2, ..., None], "gray_next": frames[None, 1:, ..., None]}
        ref = jax.jit(lambda b: j_prepare(b, (16, 16), True, 0.5, flow_params=FLOW_PARAMS))(gray)
        on_cpu = {k: torch.from_numpy(v) for k, v in gray.items()}
        got = port["members"].prepare_member_inputs(on_cpu, (16, 16), True, 0.5, flow_params=FLOW_PARAMS)
        assert got["flow"].shape == (1, 2, 16, 16, 2) and got["flow"].dtype == torch.float32
        np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(ref["rgb"]), atol=1e-4)
        np.testing.assert_allclose(got["flow"].numpy(), np.asarray(ref["flow"]), rtol=0, atol=1e-3)
        flow_w = jfb.reference_flow_hw((h, w))[1]  # resizing keeps the values: px at the flow resolution
        assert abs(got["flow"][..., 0].numpy().mean() - 2.0 * flow_w / w) < 0.05
        unscaled = port["members"].prepare_member_inputs(on_cpu, (16, 16), True, 1.0, flow_params=FLOW_PARAMS)
        assert torch.equal(unscaled["flow"], got["flow"])  # computed flow ignores input_scale
        assert torch.equal(unscaled["rgb"] * 0.5, got["rgb"])


@pytest.fixture(scope="module")
def jax_clip_flow():
    """The JAX bench's in-step flow (bench.py:563-568) for (1, 16, 32, 32)
    gray clips: turbo Farnebäck of each frame to the next, the last to the
    first, compiled once at XLA's backend optimization level 0."""
    def flow(gray):
        return jfb.farneback_flow_batch(gray, jnp.roll(gray, -1, axis=1), chunk_pairs=80, **jfb.TURBO_PARAMS)

    shape = jax.ShapeDtypeStruct(TS_RGB[:4], jnp.float32)
    return jax.jit(flow).lower(shape).compile({"xla_backend_optimization_level": 0})


def hetero_reference(families, rgb, flow):
    """(M, 1, C) softmax of every flax member in order, TwoStream on `flow`."""
    ref = []
    for mt, (apply, variables, _) in families.items():
        small = rgb[:, :16, ::2, ::2]
        args = {"I3D": (rgb,), "TWOSTREAM_I3D": (rgb, flow)}.get(mt, (small,))
        ref += [np.asarray(jax.nn.softmax(apply(v, *args), -1)) for v in variables]
    return np.stack(ref)


def test_hetero_step_matches_jax(torch, port, two_stream_flax, jax_clip_flow):
    """hetero_ensemble_step with 2 members each of I3D and TwoStream (full
    width, prestaged) and of C3D and R3D-18 (width 0.125), on 0-255 rgb and
    precomputed flow (1, 16, 32, 32): (M, B, C) probabilities equal the
    concatenation of the four flax families' softmaxes at atol 1e-5 (C3D
    and R3D on rgb[:, :16, ::2, ::2], as bench.py:560-607 feeds them; the
    I3D family's flax forwards are the canonical ones, which equal their
    prestaged forms at about 1e-6), and the SUM-fused argmax is equal.
    Then with flow224=None on a textured clip moving 2 px a frame: the
    step's turbo Farnebäck flow (gray frames, the last paired with the
    first, bench.py:563-568) within 1e-3 px of the JAX computation's, and
    the probabilities against the flax families on the JAX flow at atol
    1e-5.  No max-pool kernel launch is counted on the CPU."""
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import max_pool_3x3x3_same

    rng = np.random.default_rng(30)
    rgb = rng.uniform(0.0, 255.0, TS_RGB).astype(np.float32)
    flow = rng.uniform(0.0, 255.0, TS_FLOW).astype(np.float32)
    small = rgb[:, :16, ::2, ::2]

    def family(flax_mod, *args):
        shapes = flax_shapes(flax_mod, *[a.shape for a in args])
        return shapes, flax_forward(flax_mod, shapes, *[a.shape for a in args])

    specs = {
        "I3D": (family(ji3d.I3D(num_classes=CLASSES), rgb),
                lambda: port["i3d"].I3D(CLASSES, frames=16, stem_prestaged=True)),
        "TWOSTREAM_I3D": (two_stream_flax,
                          lambda: port["two_stream_i3d"].TwoStreamI3D(CLASSES, frames=16, stem_prestaged=True)),
        "C3D": (family(jc3d.C3D(num_classes=CLASSES, width=WIDTH), small),
                lambda: port["c3d"].C3D(CLASSES, WIDTH, clip_thw=small.shape[1:4])),
        "R3D_18": (family(jr3d.R3D(num_classes=CLASSES, depth=18, width=WIDTH), small),
                   lambda: port["r3d"].R3D(CLASSES, 18, WIDTH)),
    }
    families, members = {}, {}
    for i, (mt, ((shapes, apply), make)) in enumerate(specs.items()):
        variables = []
        for j in range(2):
            v = fill_variables(shapes, seed=40 + 2 * i + j)
            # 0-255 pixels drive the logits to hundreds: a 0.01 head keeps the softmax unsaturated
            v["params"]["fc8" if mt == "C3D" else "predictions"]["kernel"] *= 0.01
            variables.append(v)
        families[mt] = (apply, variables, [load(make, mt, v, port) for v in variables])
        members[mt] = families[mt][2]
    ref = hetero_reference(families, rgb, flow)
    before = max_pool_3x3x3_same.launches
    probs, preds = port["pipeline"].hetero_ensemble_step(members, torch.from_numpy(rgb), torch.from_numpy(flow))
    assert max_pool_3x3x3_same.launches == before
    assert probs.shape == (8, 1, CLASSES) and preds.shape == (1,)
    assert (ref.max(-1) - ref.min(-1)).min() > 1e-2  # softmaxes are not uniform
    np.testing.assert_allclose(probs.numpy(), ref, atol=1e-5)
    np.testing.assert_array_equal(preds.numpy(), np.argmax(ref.sum(0), -1))

    frames = textured_frames(rng, 16, 32, 2, 32)
    moving = np.stack([frames + 8.0 * c for c in range(3)], -1)[None]  # (1, 16, 32, 32, 3) BGR
    jflow = np.asarray(jax_clip_flow(jfb.rgb_to_gray(jnp.asarray(moving))))
    tflow = port["pipeline"].clip_flow(torch.from_numpy(moving)).numpy()
    assert tflow.shape == jflow.shape == (1, 16, 32, 32, 2)
    np.testing.assert_allclose(tflow, jflow, rtol=0, atol=1e-3)
    assert abs(tflow[0, :, 8:-8, 8:-8, 0].mean() - 2.0) < 0.1  # the last pair too moves 2 px
    ref = hetero_reference(families, moving, jflow)
    probs, preds = port["pipeline"].hetero_ensemble_step(members, torch.from_numpy(moving))
    assert max_pool_3x3x3_same.launches == before
    np.testing.assert_allclose(probs.numpy(), ref, atol=1e-5)
    np.testing.assert_array_equal(preds.numpy(), np.argmax(ref.sum(0), -1))


def test_twostream_step_matches_jax(torch, port, two_stream_flax, jax_clip_flow):
    """twostream_step_from_decisions with 2 full-width TwoStream members on
    one resident I420 row (16 frames at 96², a texture moving 3 px a frame,
    periodic in 48 px): decode, the augment with JAX's own crop and flip
    decisions (noise gates off: the Philox noise is not JAX's), turbo
    Farnebäck of the augmented gray frames (the last paired with the
    first), the shared stagings and the members, against the JAX bench's
    pipeline (bench.py:1366-1390) computed with the JAX functions and the
    canonical flax forward at atol 1e-5; the fused argmax equal.  The
    entry point, drawing its own decisions, gives probabilities that sum
    to 1 and their SUM argmax."""
    from crowded_scenes_ensemble_classification_tpu.data.wire_format import i420_to_bgr_u8 as j_i420
    from crowded_scenes_ensemble_classification_tpu.ops import augment as jaugment

    shapes, apply = two_stream_flax
    variables = []
    for j in range(2):
        v = fill_variables(shapes, seed=60 + j)
        v["params"]["predictions"]["kernel"] *= 0.01
        variables.append(v)
    make = lambda: port["two_stream_i3d"].TwoStreamI3D(CLASSES, frames=16, stem_prestaged=True)  # noqa: E731
    members = [load(make, "TWOSTREAM_I3D", v, port) for v in variables]

    t, s, out = TS_RGB[1], 96, TS_RGB[2:4]
    y = textured_frames(np.random.default_rng(31), t, s, 3, 48).astype(np.uint8)
    chroma = np.full((t, s // 2, s), 128, np.uint8)
    rows = np.concatenate([y, chroma], 1).reshape(1, -1)  # (1, t·s²·3/2), frame by frame

    key = jax.random.key(3)
    do_crop, y0, x0 = jaugment.augment_crop_decisions(key, 1, (s, s), 0.75)
    flip = [bool(jax.random.bernoulli(jax.random.split(k, 7)[2], 0.75)) for k in jax.random.split(key, 1)]
    clip = j_i420(jnp.asarray(rows[0]), t, s, s).astype(jnp.float32)
    x = jaugment.crowd11_augment(clip, jax.random.split(key, 1)[0], out, 0.75, apply_noise=False)[None]
    jflow = jax_clip_flow(jfb.rgb_to_gray(x))
    ref = np.stack([np.asarray(jax.nn.softmax(apply(v, x, jflow), -1)) for v in variables])

    augment = importlib.import_module(f"{PORT}.ops.augment")
    off = torch.zeros(1, dtype=torch.bool)
    d = augment.AugmentDecisions(torch.tensor(do_crop), torch.tensor(y0), torch.tensor(x0), torch.tensor(flip),
                                 off, off, seed=1)
    probs, preds = port["pipeline"].twostream_step_from_decisions(members, torch.from_numpy(rows), d, t, s, out)
    assert probs.shape == (2, 1, CLASSES) and preds.shape == (1,)
    assert (ref.max(-1) - ref.min(-1)).min() > 1e-2
    np.testing.assert_allclose(probs.numpy(), ref, atol=1e-5)
    np.testing.assert_array_equal(preds.numpy(), np.argmax(ref.sum(0), -1))

    drawn, fused = port["pipeline"].twostream_ensemble_step(
        members, torch.from_numpy(rows), 1, torch.Generator().manual_seed(7), batch_size=1, frames=t,
        staging=s, out_hw=out)
    assert drawn.shape == (2, 1, CLASSES)
    torch.testing.assert_close(drawn.sum(-1), torch.ones(2, 1))
    assert torch.equal(fused, drawn.sum(0).argmax(-1))

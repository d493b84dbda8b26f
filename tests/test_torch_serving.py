"""The port's serving artifact (`torch.export`) against the JAX package's
member forward, on the CPU in float32.

Two tiny I3D members (16 frames at 32², numpy-seeded flax variables
converted with `models/convert.py`) are exported by the port, saved,
loaded and served; the reference is the JAX package's jitted
`make_member_forward` (unshared, as its export's default) plus SUM or
weighted fusion on the same variables and the same uint8 batch, as
tests/test_serving.py checks the JAX export.  Then static-int8 members
exported equal to eager, and every other form: a TwoStream member with
precomputed flow and with gray pairs, and dynamic-int8 C3D members, against
the JAX member forward; a lean (`bake_params=False`) artifact against the
baked one and against eager members it was not exported from.  torch and
the port are imported by fixtures, not at collection
(tests/torch_port_memory.py).
"""

import os
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest

from crowded_scenes_ensemble_classification_tpu.core.config import ClipSpec as JClipSpec
from crowded_scenes_ensemble_classification_tpu.ensemble.members import (
    make_member_forward as j_make_member_forward,
)
from crowded_scenes_ensemble_classification_tpu.ensemble.members import stack_variables
from crowded_scenes_ensemble_classification_tpu.models import i3d as ji3d
from crowded_scenes_ensemble_classification_tpu.models.registry import ModelBundle as JModelBundle
from crowded_scenes_ensemble_classification_tpu.ops import augment as jaugment
from torch_port_memory import release_heap_after_module, torch  # noqa: F401 (fixtures)

FRAMES, HW, BATCH, MEMBERS, CLASSES = 16, 32, 2, 2, 11
SCALE = 1 / 255.0
SERVE_HW = {False: None, True: (40, 40)}  # None: clips at the model size


@pytest.fixture(scope="module")
def reference(torch):
    """flax variables of the members, and per serving size a uint8 batch
    and the JAX member forward's (M, B, C) probabilities on it."""
    from test_torch_models import random_flax_variables

    flax_mod = ji3d.I3D(num_classes=CLASSES)
    vs = [random_flax_variables(flax_mod, (1, FRAMES, HW, HW, 3), seed=40 + i) for i in range(MEMBERS)]
    bundle = JModelBundle("I3D", flax_mod, JClipSpec(FRAMES, HW, HW), CLASSES, False)
    forward = j_make_member_forward(bundle, (HW, HW), input_scale=SCALE)
    rng = np.random.default_rng(41)
    batches = {}
    for share, hw in SERVE_HW.items():
        h, w = hw or (HW, HW)
        rgb = rng.integers(0, 256, (BATCH, FRAMES, h, w, 3), dtype=np.uint8)
        # One compile of the forward serves both sizes: the 40² batch goes
        # through JAX's own resize first, the step the forward takes, and the
        # forward's resize of the 32² floats it then gets is an exact copy.
        x = jnp.asarray(rgb, jnp.float32)
        if hw is not None:
            x = jaugment.identity_resize_batch(x, (HW, HW))
        batches[share] = rgb, np.asarray(forward(stack_variables(vs), {"rgb": x}))
    return vs, batches


@pytest.mark.parametrize(
    "share,weights",
    [(False, None), (True, np.array([0.75, 0.25], np.float32))],
    ids=["unshared_sum", "shared_weighted"],
)
def test_serving_artifact_matches_jax_member_forward(torch, reference, tmp_path, monkeypatch, share, weights):
    """Export (kernel stem unshared at the model size, or prestaged members
    on a shared staging with the 40² → 32² resize in the artifact), save,
    load and serve: probabilities within 2e-5 of the JAX
    forward (tests/test_serving.py:110), fused scores within 4e-5 (two
    members' errors), predictions equal.  The graph calls the kernels'
    custom ops; the artifact runs on the device it was exported on only,
    and loading with no device named needs a card."""
    from crowded_scenes_ensemble_classification_tpu_torch.core.config import ClipSpec
    from crowded_scenes_ensemble_classification_tpu_torch.models.convert import (
        i3d_state_dict_from_flax,
    )
    from crowded_scenes_ensemble_classification_tpu_torch.models.i3d import I3D
    from crowded_scenes_ensemble_classification_tpu_torch.models.registry import ModelBundle
    from crowded_scenes_ensemble_classification_tpu_torch.serving import (
        export_ensemble,
        load_serving_artifact,
        save_serving_artifact,
        serving_batch_example,
    )

    vs, batches = reference
    rgb, ref = batches[share]
    stem = {"stem_prestaged": True} if share else {"stem_impl": "pallas"}
    members = []
    for v in vs:
        module = I3D(CLASSES, frames=FRAMES, **stem)
        module.load_state_dict(i3d_state_dict_from_flax(v), strict=True)
        members.append(ModelBundle("I3D", module.eval(), ClipSpec(FRAMES, HW, HW), CLASSES, False))
    example = serving_batch_example(members[0], BATCH, serve_hw=SERVE_HW[share])
    assert example["rgb"].shape == rgb.shape and example["rgb"].dtype == torch.uint8

    program = export_ensemble(members, example, weights=weights, input_scale=SCALE, share_stem_staging=share)
    ops = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert "csec.max_pool_3x3x3_same.default" in ops
    assert ("csec.stem_conv_7x7x7_s2.default" in ops) != share
    path = save_serving_artifact(str(tmp_path / "ensemble.zip"), program, {"members": ["m0", "m1"]})
    serve, meta = load_serving_artifact(path, device="cpu")
    assert meta == {"members": ["m0", "m1"], "device": "cpu"}
    out = serve({"rgb": torch.from_numpy(rgb)})

    w = np.ones(MEMBERS, np.float32) if weights is None else weights
    fused = np.einsum("mbc,m->bc", ref, w)
    np.testing.assert_allclose(out["probs"].numpy(), ref, atol=2e-5)
    np.testing.assert_allclose(out["fused"].numpy(), fused, atol=4e-5)
    np.testing.assert_array_equal(out["preds"].numpy(), fused.argmax(-1))

    with pytest.raises(ValueError, match="exported for cpu"):
        load_serving_artifact(path, device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_serving_artifact(path)


STATIC_CASES = ["C3D", "R3D_18", "I3D_prestaged_shared", "I3D_calibrate_members"]


def _static_member(torch, case, gen, calib_batch):
    """A small static-int8 member (f32, BN spread, seeded weights) of one
    of STATIC_CASES, baked by hand or by `calibrate_members` on
    `calib_batch`; with its clip geometry, staging form and the state-dict
    keys it had once baked, before it was switched to 'static'."""
    from crowded_scenes_ensemble_classification_tpu_torch.core.config import ClipSpec
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.members import calibrate_members
    from crowded_scenes_ensemble_classification_tpu_torch.models.c3d import C3D
    from crowded_scenes_ensemble_classification_tpu_torch.models.common import s2d_stem_stage
    from crowded_scenes_ensemble_classification_tpu_torch.models.i3d import I3D
    from crowded_scenes_ensemble_classification_tpu_torch.models.quantize import (
        calibrate,
        quantize_variables,
        set_quant_mode,
    )
    from crowded_scenes_ensemble_classification_tpu_torch.models.r3d import R3D

    if case == "C3D":
        module = C3D(CLASSES, 0.125, clip_thw=(FRAMES, HW, HW), generator=gen, quant="calib")
    elif case == "R3D_18":
        module = R3D(CLASSES, 18, 0.125, generator=gen, quant="calib")
    else:
        module = I3D(CLASSES, frames=FRAMES, stem_prestaged=True, generator=gen, quant="calib")
    for m in module.modules():  # BN statistics away from (0, 1), so every layer matters
        if isinstance(m, torch.nn.BatchNorm3d):
            m.running_var.uniform_(0.3, 0.7, generator=gen)
            m.running_mean.normal_(0.0, 0.1, generator=gen)
            m.bias.data.normal_(0.0, 0.1, generator=gen)
    module.eval()
    share = case.startswith("I3D")
    x = calib_batch["rgb"].float() * SCALE
    if case == "I3D_calibrate_members":
        real = quantize_variables
        keys = []

        def quantize_and_record(m):  # the keys once baked, before the switch to 'static'
            real(m)
            keys.append(set(m.state_dict()))
            return m

        with mock.patch(f"{calibrate_members.__module__}.quantize_variables", quantize_and_record):
            (module,) = calibrate_members([module], [calib_batch], (HW, HW), num_batches=1, input_scale=SCALE)
        keys = keys[0]
    else:
        calibrate(module, [s2d_stem_stage(x) if share else x])
        keys = set(quantize_variables(module).state_dict())
        set_quant_mode(module, "static")
    return module, ClipSpec(FRAMES, HW, HW), share, keys


def _fresh_static_member(torch, case):
    """A baked static member of `case`'s architecture on other weights
    (seed 99), with every activation scale at 1 instead of a calibration
    pass: it holds static operands of its own, so a load must refresh
    them."""
    from crowded_scenes_ensemble_classification_tpu_torch.models.c3d import C3D
    from crowded_scenes_ensemble_classification_tpu_torch.models.i3d import I3D
    from crowded_scenes_ensemble_classification_tpu_torch.models.quantize import (
        quant_sites,
        quantize_variables,
        set_quant_mode,
    )
    from crowded_scenes_ensemble_classification_tpu_torch.models.r3d import R3D

    gen = torch.Generator().manual_seed(99)
    if case == "C3D":
        module = C3D(CLASSES, 0.125, clip_thw=(FRAMES, HW, HW), generator=gen, quant="calib")
    elif case == "R3D_18":
        module = R3D(CLASSES, 18, 0.125, generator=gen, quant="calib")
    else:
        module = I3D(CLASSES, frames=FRAMES, stem_prestaged=True, generator=gen, quant="calib")
    sites = quant_sites(module).values()
    for m in sites:
        m.act_absmax.fill_(1.0)
    set_quant_mode(quantize_variables(module), "static")
    assert all(m.static_wp is not None for m in sites)
    return module.eval()


@pytest.mark.parametrize("case", STATIC_CASES)
def test_static_int8_member_exports_equal_to_eager(torch, tmp_path, case):
    """A baked static-int8 member (C3D and R3D-18 at width 0.125, a
    prestaged I3D on a shared staging, baked by hand or by
    `calibrate_members`) exports: its program calls the int8 conv and
    quantize ops, holds the packed weights as constants, and the loaded
    artifact's probabilities equal the eager `make_member_forward`'s
    exactly.  The held operands are non-persistent: the state dict keeps
    the keys it had once baked, and loads strictly into a fresh
    quant='static' model that computes the same probabilities."""
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.members import make_member_forward
    from crowded_scenes_ensemble_classification_tpu_torch.models.quantize import quant_sites
    from crowded_scenes_ensemble_classification_tpu_torch.models.registry import ModelBundle
    from crowded_scenes_ensemble_classification_tpu_torch.serving import (
        export_ensemble,
        load_serving_artifact,
        save_serving_artifact,
        serving_batch_example,
    )

    gen = torch.Generator().manual_seed(60 + STATIC_CASES.index(case))
    rng = np.random.default_rng(61)
    calib = {"rgb": torch.from_numpy(rng.integers(0, 256, (BATCH, FRAMES, HW, HW, 3), dtype=np.uint8))}
    batch = {"rgb": torch.from_numpy(rng.integers(0, 256, (BATCH, FRAMES, HW, HW, 3), dtype=np.uint8))}
    module, clip, share, keys = _static_member(torch, case, gen, calib)
    assert all(s.quant_mode == "static" for s in quant_sites(module).values())
    state = module.state_dict()
    assert set(state) == keys and not any("static_" in k for k in state)

    eager = make_member_forward([module], (HW, HW), share_stem_staging=share, input_scale=SCALE)(batch)
    bundle = ModelBundle(case.split("_")[0] if case.startswith("I3D") else case, module, clip, CLASSES, False)
    program = export_ensemble([bundle], serving_batch_example(bundle, BATCH), input_scale=SCALE,
                              share_stem_staging=share)
    ops = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert {"csec.int8_conv3d.default", "csec.quantize_int8.default"} <= ops
    assert any(k.endswith("static_wp") for k in program.constants)
    path = save_serving_artifact(str(tmp_path / "static.zip"), program, {})
    serve, _ = load_serving_artifact(path, device="cpu")
    out = serve(batch)
    assert torch.equal(out["probs"], eager)
    assert torch.equal(out["preds"], eager[0].argmax(-1))

    fresh = _fresh_static_member(torch, case)
    held = {n: m.static_wp.clone() for n, m in quant_sites(fresh).items()}
    fresh.load_state_dict(state, strict=True)
    assert all(not torch.equal(m.static_wp, held[n]) for n, m in quant_sites(fresh).items())
    again = make_member_forward([fresh], (HW, HW), share_stem_staging=share, input_scale=SCALE)(batch)
    assert torch.equal(again, eager)


# ----------------------------------------------------------------------
# Every family and input form: TwoStream with precomputed flow and with
# gray pairs, dynamic int8, and the lean (bake_params=False) form
# ----------------------------------------------------------------------

TS_FRAMES, TS_HW = 16, 32


@pytest.fixture(scope="module")
def twostream(torch):
    """One TwoStream member from reference-layout checkpoints (its trunks
    from `random_i3d_h5_layers`, a numpy-drawn fusion head): the flax
    variables, the port's member on them, and uint8 batches of both flow
    forms: rgb, precomputed flow, and gray pairs of a texture moving 1 px a
    frame (Farnebäck is well posed on it)."""
    from oracle_i3d import random_i3d_h5_layers
    from test_torch_zoo import textured_frames

    from crowded_scenes_ensemble_classification_tpu.models import weights_io as jwio
    from crowded_scenes_ensemble_classification_tpu_torch.core.config import ClipSpec
    from crowded_scenes_ensemble_classification_tpu_torch.models.convert import state_dict_from_flax
    from crowded_scenes_ensemble_classification_tpu_torch.models.registry import ModelBundle
    from crowded_scenes_ensemble_classification_tpu_torch.models.two_stream_i3d import TwoStreamI3D

    rgb_layers, flow_layers = random_i3d_h5_layers(seed=50), random_i3d_h5_layers(seed=51, stream="flow")
    v = jwio.twostream_variables_from_keras(rgb_layers, flow_layers)
    rng = np.random.default_rng(52)
    v["params"]["predictions"] = {"kernel": rng.normal(0, 2048 ** -0.5, (2048, CLASSES)).astype(np.float32),
                                  "bias": rng.normal(0, 0.1, CLASSES).astype(np.float32)}
    with torch.device("meta"):  # the weights all come from `v`: skip the random init
        module = TwoStreamI3D(CLASSES, frames=TS_FRAMES).eval()
    module.load_state_dict(state_dict_from_flax("TWOSTREAM_I3D", v), strict=True, assign=True)
    bundle = ModelBundle("TWOSTREAM_I3D", module, ClipSpec(TS_FRAMES, TS_HW, TS_HW, flow_channels=2), CLASSES, True)
    shape = (BATCH, TS_FRAMES, TS_HW, TS_HW)
    frames = np.stack([textured_frames(rng, TS_FRAMES + 1, TS_HW, 1, 16) for _ in range(BATCH)]).astype(np.uint8)
    batch = {"rgb": rng.integers(0, 256, shape + (3,), dtype=np.uint8),
             "flow": rng.integers(0, 256, shape + (2,), dtype=np.uint8),
             "gray": frames[:, :-1, ..., None], "gray_next": frames[:, 1:, ..., None]}
    return v, bundle, batch


@pytest.mark.parametrize("precomputed", [True, False], ids=["precomputed_flow", "gray_pairs"])
def test_twostream_artifact_matches_jax_member_forward(torch, twostream, precomputed):
    """A TwoStream member exported with precomputed flow, or with gray pairs
    from which the program computes turbo Farnebäck flow (`flow_params`;
    max_disp=4 clamps nothing of a 1 px motion), and run (saving and loading
    a TwoStream program takes 8-18 s here; the tests above save and load
    the other forms, and `chip_smoke.py` the gray-pair form on the card):
    probabilities within 2e-5 of the JAX member forward on the same
    variables and uint8 batch with precomputed flow (test 1's bar), within
    1e-4 with computed flow (the flows agree within 1e-3 px,
    tests/test_torch_flow.py), predictions equal.  The program computes
    the flow in its graph and runs both trunks' pool branches on the
    max-pool kernel's op."""
    from test_torch_zoo import FLOW_PARAMS

    from crowded_scenes_ensemble_classification_tpu.models.two_stream_i3d import TwoStreamI3D as JTwoStream
    from crowded_scenes_ensemble_classification_tpu_torch.serving import export_ensemble, serving_batch_example

    v, bundle, batch = twostream
    keys = ("rgb", "flow") if precomputed else ("rgb", "gray", "gray_next")
    batch = {k: batch[k] for k in keys}
    flow_params = None if precomputed else dict(FLOW_PARAMS)
    jbundle = JModelBundle("TWOSTREAM_I3D", JTwoStream(num_classes=CLASSES),
                           JClipSpec(TS_FRAMES, TS_HW, TS_HW, flow_channels=2), CLASSES, True)
    ref = np.asarray(j_make_member_forward(jbundle, (TS_HW, TS_HW), input_scale=SCALE, flow_params=flow_params)(
        stack_variables([v]), batch))

    example = serving_batch_example(bundle, BATCH, flow_precomputed=precomputed)
    assert sorted(example) == sorted(keys)
    assert all(example[k].shape == batch[k].shape and example[k].dtype == torch.uint8 for k in keys)
    program = export_ensemble([bundle], example, input_scale=SCALE, flow_params=flow_params)
    ops = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert ops.count("csec.max_pool_3x3x3_same.default") == 18
    with torch.no_grad():
        out = program.module()({k: torch.from_numpy(a) for k, a in batch.items()})
    np.testing.assert_allclose(out["probs"].numpy(), ref, atol=2e-5 if precomputed else 1e-4)
    np.testing.assert_array_equal(out["preds"].numpy(), ref.sum(0).argmax(-1))


def _c3d_members(torch, count, quant, seed=70):
    """`count` small C3D members (width 0.125, 16 × 32²) with seeded weights
    and their flax variables."""
    from test_torch_models import random_flax_variables

    from crowded_scenes_ensemble_classification_tpu.models import c3d as jc3d
    from crowded_scenes_ensemble_classification_tpu_torch.core.config import ClipSpec
    from crowded_scenes_ensemble_classification_tpu_torch.models.c3d import C3D
    from crowded_scenes_ensemble_classification_tpu_torch.models.convert import state_dict_from_flax
    from crowded_scenes_ensemble_classification_tpu_torch.models.registry import ModelBundle

    flax_mod = jc3d.C3D(num_classes=CLASSES, width=0.125)
    vs = [random_flax_variables(flax_mod, (1, FRAMES, HW, HW, 3), seed=seed + i) for i in range(count)]
    bundles = []
    for v in vs:
        module = C3D(CLASSES, 0.125, clip_thw=(FRAMES, HW, HW), quant=quant).eval()
        module.load_state_dict(state_dict_from_flax("C3D", v), strict=True)
        bundles.append(ModelBundle("C3D", module, ClipSpec(FRAMES, HW, HW), CLASSES, False))
    return vs, bundles


def test_dynamic_int8_c3d_artifact_matches_jax_member_forward(torch, tmp_path):
    """Two dynamic-int8 C3D members (what the JAX CLI's `export --quant`
    bakes): the program calls the int8 conv and quantize ops, and the
    served probabilities are within 1e-3 of the JAX quant=True member
    forward on the same variables (the whole-model int8 bar of
    tests/test_torch_quant.py: an activation code can flip where the two
    packages round a float apart), predictions equal."""
    from crowded_scenes_ensemble_classification_tpu.models import c3d as jc3d
    from crowded_scenes_ensemble_classification_tpu_torch.serving import (
        export_ensemble,
        load_serving_artifact,
        save_serving_artifact,
        serving_batch_example,
    )

    vs, bundles = _c3d_members(torch, MEMBERS, quant=True)
    jbundle = JModelBundle("C3D", jc3d.C3D(num_classes=CLASSES, width=0.125, quant=True),
                           JClipSpec(FRAMES, HW, HW), CLASSES, False)
    rgb = np.random.default_rng(71).integers(0, 256, (BATCH, FRAMES, HW, HW, 3), dtype=np.uint8)
    ref = np.asarray(j_make_member_forward(jbundle, (HW, HW), input_scale=SCALE)(stack_variables(vs), {"rgb": rgb}))
    program = export_ensemble(bundles, serving_batch_example(bundles[0], BATCH), input_scale=SCALE)
    ops = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert ops.count("csec.int8_conv3d.default") == ops.count("csec.quantize_int8.default") == 8 * MEMBERS
    serve, _ = load_serving_artifact(save_serving_artifact(str(tmp_path / "dyn.zip"), program, {}), device="cpu")
    out = serve({"rgb": torch.from_numpy(rgb)})
    np.testing.assert_allclose(out["probs"].numpy(), ref, atol=1e-3)
    np.testing.assert_array_equal(out["preds"].numpy(), ref.sum(0).argmax(-1))


def test_lean_artifact_serves_the_state_it_is_given(torch, tmp_path):
    """bake_params=False: the program takes (params, batch), `params` the
    members' state dicts stacked by `stack_variables`.  Its artifact is
    smaller than the baked one and serves what the baked one serves, to the
    bit.  Exported from static-int8 member A and served with member B's
    stacked state, it equals B's eager forward, not A's: a program that
    baked A's packed operands (its non-persistent buffers) would serve A's
    int8 weights with B's float ones."""
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.members import (
        make_member_forward,
        stack_variables as stack_state,
    )
    from crowded_scenes_ensemble_classification_tpu_torch.models.registry import ModelBundle
    from crowded_scenes_ensemble_classification_tpu_torch.serving import (
        export_ensemble,
        load_serving_artifact,
        save_serving_artifact,
        serving_batch_example,
    )

    rng = np.random.default_rng(81)
    calib = {"rgb": torch.from_numpy(rng.integers(0, 256, (BATCH, FRAMES, HW, HW, 3), dtype=np.uint8))}
    batch = {"rgb": torch.from_numpy(rng.integers(0, 256, (BATCH, FRAMES, HW, HW, 3), dtype=np.uint8))}
    members = []
    for i in range(3):  # static-int8 C3Ds at width 0.125
        module, clip, _, _ = _static_member(torch, "C3D", torch.Generator().manual_seed(80 + i), calib)
        members.append(ModelBundle("C3D", module, clip, CLASSES, False))
    a, b = members[:2], members[2:] + members[:1]  # B = (member 2, member 0)
    example = serving_batch_example(a[0], BATCH)

    baked = export_ensemble(a, example, input_scale=SCALE)
    lean = export_ensemble(a, example, input_scale=SCALE, bake_params=False)
    assert not lean.state_dict.keys() - {"weights"} and not any("static_" in k for k in lean.constants)
    paths = {form: save_serving_artifact(str(tmp_path / f"{form}.zip"), p, {}) for form, p in
             (("baked", baked), ("lean", lean))}
    assert os.path.getsize(paths["lean"]) < os.path.getsize(paths["baked"])
    serve_baked, _ = load_serving_artifact(paths["baked"], device="cpu")
    serve_lean, _ = load_serving_artifact(paths["lean"], device="cpu")
    out = serve_lean(stack_state([m.module.state_dict() for m in a]), batch)
    assert torch.equal(out["probs"], serve_baked(batch)["probs"])

    eager = {name: make_member_forward([m.module for m in ms], (HW, HW), input_scale=SCALE)(batch)
             for name, ms in (("a", a), ("b", b))}
    out_b = serve_lean(stack_state([m.module.state_dict() for m in b]), batch)
    assert torch.equal(out_b["probs"], eager["b"])
    assert not torch.equal(out_b["probs"][0], eager["a"][0])

"""The port's serving artifact (`torch.export`) against the JAX package's
member forward, on the CPU in float32.

Two tiny I3D members (16 frames at 32², numpy-seeded flax variables
converted with `models/convert.py`) are exported by the port, saved,
loaded and served; the reference is the JAX package's jitted
`make_member_forward` (unshared, as its export's default) plus SUM or
weighted fusion on the same variables and the same uint8 batch, as
tests/test_serving.py checks the JAX export.  torch and the port are
imported by fixtures, not at collection (tests/torch_port_memory.py).
"""

from unittest import mock

import numpy as np
import pytest

from crowded_scenes_ensemble_classification_tpu.core.config import ClipSpec as JClipSpec
from crowded_scenes_ensemble_classification_tpu.ensemble.members import (
    make_member_forward as j_make_member_forward,
)
from crowded_scenes_ensemble_classification_tpu.ensemble.members import stack_variables
from crowded_scenes_ensemble_classification_tpu.models import i3d as ji3d
from crowded_scenes_ensemble_classification_tpu.models.registry import ModelBundle as JModelBundle
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
        batches[share] = rgb, np.asarray(forward(stack_variables(vs), {"rgb": rgb}))
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

    fresh, _, _, _ = _static_member(torch, case, torch.Generator().manual_seed(99), calib)
    fresh.load_state_dict(state, strict=True)
    again = make_member_forward([fresh], (HW, HW), share_stem_staging=share, input_scale=SCALE)(batch)
    assert torch.equal(again, eager)

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

"""The port's fusion against the JAX package, the resident step's control
flow on the CPU, and the port's independence from JAX.  torch and the port
are imported by fixtures, not at collection (tests/torch_port_memory.py)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from crowded_scenes_ensemble_classification_tpu.ensemble import fusion as jfusion
from torch_port_memory import release_heap_after_module, torch  # noqa: F401 (fixtures)

REPO = Path(__file__).resolve().parents[1]
PORT = "crowded_scenes_ensemble_classification_tpu_torch"


@pytest.mark.parametrize("weights", ["sum", "weighted", jfusion.MAXIMUM], ids=["sum", "weighted", "maximum"])
def test_fuse_predictions_matches_jax(torch, weights):
    """SUM, weighted and MAXIMUM fusion give the JAX package's predictions
    exactly (argmax of the same float32 sums)."""
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble import fusion

    assert fusion.MAXIMUM == jfusion.MAXIMUM
    rng = np.random.default_rng(0)
    yhats = rng.dirichlet(np.ones(11), size=(4, 64)).astype(np.float32)
    w = {
        "sum": fusion.sum_weights(4),
        "weighted": jfusion.normalize_l1([0.1, 0.5, 0.2, 0.9]),
        fusion.MAXIMUM: fusion.MAXIMUM,
    }[weights]
    ref = jfusion.fuse_predictions(yhats, w)
    got = fusion.fuse_predictions(torch.from_numpy(yhats), w)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_resident_step_on_cpu(torch):
    """Two steps of the main path at a small geometry on the CPU: shapes,
    probabilities that sum to 1, batches taken modulo the resident rows,
    replay from the same generator seed, the step equal to its decisions
    drawn and applied apart (also with the noise gates off), and no kernel
    launch counted."""
    import dataclasses

    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.pipeline import (
        AUGMENT_P,
        ensemble_step_from_decisions,
        resident_ensemble_step,
    )
    from crowded_scenes_ensemble_classification_tpu_torch.ops.augment import draw_decisions
    from crowded_scenes_ensemble_classification_tpu_torch.models.i3d import I3D
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import (
        max_pool_3x3x3_same,
    )
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.noise import salt_pepper

    frames, staging, out, b = 16, 72, 32, 2
    g = torch.Generator().manual_seed(0)
    members = [I3D(11, frames=frames, stem_prestaged=True, generator=g).eval() for _ in range(2)]
    rows = torch.from_numpy(
        np.random.default_rng(1).integers(0, 256, (3 * b, frames * staging * staging * 3 // 2), dtype=np.uint8)
    )
    launches = (max_pool_3x3x3_same.launches, salt_pepper.launches)
    step = lambda i, seed: resident_ensemble_step(  # noqa: E731
        members, rows, i, torch.Generator().manual_seed(seed), batch_size=b,
        frames=frames, staging=staging, out_hw=(out, out),
    )
    probs, fused = step(0, 5)
    assert probs.shape == (2, b, 11) and fused.shape == (b,)
    torch.testing.assert_close(probs.sum(-1), torch.ones(2, b))
    torch.testing.assert_close(fused, probs.sum(0).argmax(-1))
    again, _ = step(3, 5)  # batch 3 of 3 resident batches wraps to batch 0
    assert torch.equal(again, probs)

    decisions = draw_decisions(torch.Generator().manual_seed(5), b, (staging, staging), AUGMENT_P)
    apart = lambda d: ensemble_step_from_decisions(  # noqa: E731
        members, rows[:b], d, frames, staging, (out, out)
    )
    assert torch.equal(apart(decisions)[0], probs)
    off = torch.zeros_like(decisions.salt)
    quiet, _ = apart(dataclasses.replace(decisions, salt=off, pepper=off))
    assert quiet.shape == probs.shape
    assert (max_pool_3x3x3_same.launches, salt_pepper.launches) == launches


def test_port_imports_no_jax():
    """Every module of the port imports without JAX, flax or the JAX
    package (the card's machine has none of them)."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / PORT).rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'crowded_scenes_ensemble_classification_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(" + repr(modules) + "))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) == len(modules) > 15

"""The plain reference against the program, on the CPU at a small size, in
float32 (the kernels' plain versions run there): the same weights, inputs
and decisions give the same probabilities and the same first training
step; a fault planted in the program fails the comparison."""

from __future__ import annotations

import types

import pytest
import torch

from conftest import SEED, tiny

F32 = {"logit_err": 1e-4, "pred_err": 0.0}


@pytest.mark.parametrize("cell", ["i3d_crowd11.probs_b48", "hetero4x4_crowd11.probs_b16"])
def test_probabilities_equal_the_program_in_float32(tiny_run, cell):
    out = tiny_run(cell, batch=1 if "hetero" in cell else 2)
    for name, limit in F32.items():
        assert out["readings"][name] <= limit, out["readings"]
    assert out["failed"] == 0


def _first_step(monkeypatch=None):
    from benchmark.entries import resident_train

    cell, cfg, tr = tiny("i3d_crowd11.train_b64", batch=4)
    tr["checked_steps"] = 1
    ctx = types.SimpleNamespace(seed=SEED, device=torch.device("cpu"), cell=cell, config=cfg, traffic=tr,
                                control=None)
    entry = resident_train.Entry(ctx)
    record = entry.window(0.2, __import__("contextlib").nullcontext)
    entry.release()
    return entry.check(record)["readings"]


def test_first_training_step_equals_the_program_in_float32():
    r = _first_step()
    assert r["loss_err"] <= 1e-5 and r["grad_err"] <= 1e-4 and r["update_err"] <= 1e-4, r


def test_planted_batchnorm_fault_fails(tiny_run, monkeypatch):
    import crowded_scenes_ensemble_classification_tpu_torch.models.common as common

    monkeypatch.setattr(common, "KERAS_BN_EPS", 0.1)
    out = tiny_run("i3d_crowd11.probs_b48")
    assert out["readings"]["logit_err"] > F32["logit_err"]


def test_planted_pad_fault_fails_training(monkeypatch):
    import crowded_scenes_ensemble_classification_tpu_torch.models.common as common

    monkeypatch.setattr(common, "same_pads", lambda n, k, s: (k // 2, k // 2) if k > 1 else (0, 0))
    r = _first_step()
    assert r["loss_err"] > 1e-5 or r["grad_err"] > 1e-4

"""A whole run (set-up, window, check) on the CPU at a small size with the
timed path broken underneath: `correct` has to come out false under the
cell's own limits, once for each fault the cell can have.  (One chip: no
cell has an exchange between chips to leave out.)

- a step that returns its state unchanged: the probabilities entries
  answer each batch with the previous call's answer; training's optimizer
  step does nothing;
- half of the batch left out: the second half of a batch's clips answered
  with the first half's answers; training's gather keeps the first half
  of the rows, the loss the mean over them;
- an answer altered where it is produced: every fused prediction moved to
  the next class.
A sound run of the same size passes."""

from __future__ import annotations

import functools

import pytest
import torch

PROBS_CELLS = ("i3d_crowd11.probs_b48", "i3d_crowd11.probs_int8_b48", "hetero4x4_crowd11.probs_b16")
STEPS = {"i3d_crowd11.probs_b48": "resident_ensemble_step", "i3d_crowd11.probs_int8_b48": "resident_ensemble_step",
         "hetero4x4_crowd11.probs_b16": "hetero_ensemble_step"}


def _stale(step):
    """Each call hands back the previous call's answer (the warm-up's last
    for the window's first), as a step that leaves its state unchanged."""
    last = {}

    @functools.wraps(step)
    def run(*args, **kwargs):
        out = step(*args, **kwargs)
        prev = last.get("out", out)
        last["out"] = out
        return prev

    return run


def _half_batch(step):
    @functools.wraps(step)
    def run(*args, **kwargs):
        probs, preds = step(*args, **kwargs)
        h = probs.shape[1] // 2
        return torch.cat([probs[:, :h], probs[:, :h]], dim=1), torch.cat([preds[:h], preds[:h]])

    return run


def _altered(step):
    @functools.wraps(step)
    def run(*args, **kwargs):
        probs, preds = step(*args, **kwargs)
        return probs, (preds + 1) % probs.shape[-1]

    return run


def _kw(cell):
    """Hetero runs a few 224^2 batches in its window on the CPU."""
    return {"batch": 2, "members": 1, "seconds": 4.0} if "hetero" in cell else {"batch": 4, "members": 2}


@pytest.mark.parametrize("cell", PROBS_CELLS)
def test_sound_run_passes(tiny_run, cell):
    assert tiny_run(cell, **_kw(cell))["correct"]


@pytest.mark.parametrize("fault", [_stale, _half_batch, _altered], ids=["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", PROBS_CELLS)
def test_probabilities_fault_is_not_correct(tiny_run, monkeypatch, cell, fault):
    import crowded_scenes_ensemble_classification_tpu_torch.ensemble.pipeline as pipeline

    monkeypatch.setattr(pipeline, STEPS[cell], fault(getattr(pipeline, STEPS[cell])))
    out = tiny_run(cell, **_kw(cell))
    assert not out["correct"], out["checks"]


def test_training_sound_run_passes(tiny_run):
    assert tiny_run("i3d_crowd11.train_b64", batch=4)["correct"]


def test_training_unchanged_state_is_not_correct(tiny_run, monkeypatch):
    from crowded_scenes_ensemble_classification_tpu_torch.train import state

    monkeypatch.setattr(state.KerasSGD, "step", lambda self, closure=None: None)
    assert not tiny_run("i3d_crowd11.train_b64", batch=4)["correct"]


def test_training_half_batch_is_not_correct(tiny_run, monkeypatch):
    from crowded_scenes_ensemble_classification_tpu_torch.train import engine

    gather = engine._gather

    def half(batch, device):
        out = gather(batch, device)
        return {k: v[: v.shape[0] // 2] for k, v in out.items()}

    monkeypatch.setattr(engine, "_gather", half)
    assert not tiny_run("i3d_crowd11.train_b64", batch=4)["correct"]


def test_nan_answers_fail(tiny_run, monkeypatch):
    import crowded_scenes_ensemble_classification_tpu_torch.ensemble.pipeline as pipeline

    step = pipeline.resident_ensemble_step

    def nan(*args, **kwargs):
        probs, preds = step(*args, **kwargs)
        return torch.full_like(probs, float("nan")), preds

    monkeypatch.setattr(pipeline, "resident_ensemble_step", nan)
    out = tiny_run("i3d_crowd11.probs_b48", batch=4, members=2)
    assert not out["correct"] and out["failed"] > 0

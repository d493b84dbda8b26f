"""The harness's own tests: `python -m pytest benchmark/tests -q` from the
repository's root (the repository's `pytest tests/` does not collect them).

`tiny_run` runs a cell's whole run on the CPU at a size the CPU holds: the
cell's entry, window, check and metrics, with the configuration and the
traffic cut down (fewer members, a smaller batch and frame size, float32
unless asked otherwise), the cell's own limits."""

from __future__ import annotations

import copy
import json
import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SEED = 2**31 + 977


def load(kind: str, name: str) -> dict:
    with open(os.path.join(ROOT, "benchmark", kind, name + ".json")) as f:
        return json.load(f)


def tiny(cell_name: str, dtype: str = "float32", batch: int = 2, members: int = 1):
    """(cell, config, traffic) of `cell_name` at a CPU size."""
    cell = load("workloads", cell_name)
    cfg = copy.deepcopy(load("configs", cell["config"]))
    tr = copy.deepcopy(load("traffic", cell["traffic"]))
    hetero = len(cfg["members"]) > 1
    cfg["size"] = 224 if hetero else 32  # C3D's fc6 is sized for the clip spec's 112^2
    cfg["members"] = {f: members for f in cfg["members"]}
    if dtype == "float32":
        cfg["weight_dtype"] = "float32"
    if cfg["precision"] != "int8":
        cfg["compute_dtype"] = dtype
    if "train" in cfg:
        cfg["train"].update(out_hw=[32, 32], compute_dtype=dtype)
    tr.update(batch=batch, resident_batches=3, warm_steps=2, check_clips=16, checked_steps=1)
    if "staging" in tr:
        tr["staging"] = 96
    if "size" in tr:
        tr["size"] = cfg["size"]
    return cell, cfg, tr


@pytest.fixture
def tiny_run():
    def run(cell_name: str, seconds: float = 0.5, seed: int = SEED, **kw):
        import torch

        from benchmark import harness

        cell, cfg, tr = tiny(cell_name, **kw)
        return harness.measure(cell, cfg, tr, seed, seconds, False, torch.device("cpu"), [],
                               time.perf_counter())

    return run

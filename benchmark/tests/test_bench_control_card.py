"""Each cell's control fails its limits, on the card, at the cell's own
size, with a short window (marked `cuda`; skips without a card):

- `i3d_crowd11.probs_b48` (bf16): the program's own lower path, its static
  int8 members (the `i3d_crowd11.probs_int8_b48` run), against the bf16
  cell's limits;
- `i3d_crowd11.probs_int8_b48`: the reference in int4 in the program's place;
- `hetero4x4_crowd11.probs_b16` (bf16): the reference in float8 (e4m3) in
  the program's place.

The training cell's float8 control does not fail its numbers, which is why
that cell is not in BENCHMARK.json (PERF.md, Open questions).

Run from the repository's root: `python -m pytest benchmark/tests -m cuda`.
`benchmark/readings.py` reads the same on many seeds."""

from __future__ import annotations

import time

import pytest

from conftest import SEED, load

pytestmark = pytest.mark.cuda

CONTROLS = {
    "i3d_crowd11.probs_b48": ("i3d_crowd11.probs_int8_b48", None),
    "i3d_crowd11.probs_int8_b48": ("i3d_crowd11.probs_int8_b48", "int4"),
    "hetero4x4_crowd11.probs_b16": ("hetero4x4_crowd11.probs_b16", "fp8"),
}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell", sorted(CONTROLS))
def test_control_fails_the_cells_limits(card, cell):
    from benchmark import check, harness

    harness.set_cache_dirs()
    run_cell, control = CONTROLS[cell]
    spec = load("workloads", run_cell)
    out = harness.measure(spec, load("configs", spec["config"]), load("traffic", spec["traffic"]),
                          SEED, 2.0, False, card, [], time.perf_counter(), control)
    verdict = check.verdict(out["readings"], load("workloads", cell)["limits"])
    assert not all(v["ok"] for v in verdict), verdict

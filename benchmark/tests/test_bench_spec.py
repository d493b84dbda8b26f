"""BENCHMARK.json against its required shapes and names, and every
configuration, cell, mix, entry and metric found by name."""

from __future__ import annotations

import json
import os
import re

import pytest

from conftest import ROOT, load

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    SPEC = json.load(f)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("item", SPEC["configs"] + SPEC["workloads"] + METRICS, ids=lambda i: i["name"])
def test_names_and_text(item):
    assert NAME.match(item["name"])
    for key in ("why", "layer", "source"):
        if key in item:
            assert 1 <= len(item[key]) <= 200 and "\n" not in item[key] and "\t" not in item[key]
    if "unit" in item:
        assert UNIT.match(item["unit"]) and item["better"] in ("lower", "higher")


def test_names_are_unique():
    for group in (SPEC["configs"], SPEC["workloads"], METRICS):
        names = [i["name"] for i in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_configuration_found_by_name(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"] == f"benchmark/configs/{cfg['name']}.json"
    data = load("configs", cfg["name"])
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"] and data["reduced"] == cfg["reduced"]
    assert any(w["config"] == cfg["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    cell = load("workloads", w["name"])
    assert (cell["config"], cell["traffic"], cell["why"]) == (w["config"], w["traffic"], w["why"])
    load("traffic", w["traffic"])
    assert os.path.exists(os.path.join(ROOT, "benchmark", "entries", cell["entry"] + ".py"))
    assert cell["limits"] and all(v >= 0 for v in cell["limits"].values())
    pairs = [(x["config"], x["traffic"]) for x in SPEC["workloads"]]
    assert pairs.count((w["config"], w["traffic"])) == 1


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_reader_found_by_name(m):
    from benchmark import harness

    module = harness.load_module("metrics", m["name"])
    assert module.UNIT == m["unit"] and callable(module.read)
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    from benchmark import harness

    for w in SPEC["workloads"]:
        e2e = harness.metric_names(w["name"], False)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metric_names(w["name"], True)


def test_per_layer_metrics_move_a_metric_their_cells_report():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    layers = {}
    for m in SPEC["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell])
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert len(layers) >= 4


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in SPEC["end_to_end"] if m["name"] == "setup_s")["bound"] == 0.25

"""What the benchmark runs imports neither JAX nor the JAX package, by
whole top-level name (the port's name begins with the JAX package's), and
the reference imports nothing of the program."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "crowded_scenes_ensemble_classification_tpu"}
PROGRAM = "crowded_scenes_ensemble_classification_tpu_torch"


def _sources(folder: str):
    for dirpath, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _top_level_imports(path: str):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources(BENCH)), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_by_whole_top_level_name(path):
    assert not set(_top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources(os.path.join(BENCH, "reference"))),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in set(_top_level_imports(path))


def test_a_run_loads_no_jax():
    """Import everything a run imports (the harness, every entry, metric and
    the program's modules the entries use) in a fresh process and look at
    sys.modules."""
    code = f"""
import os, sys
sys.path.insert(0, {ROOT!r})
from benchmark import harness
import crowded_scenes_ensemble_classification_tpu_torch.ensemble.pipeline
import crowded_scenes_ensemble_classification_tpu_torch.ensemble.members
import crowded_scenes_ensemble_classification_tpu_torch.models
import crowded_scenes_ensemble_classification_tpu_torch.train
import torch
harness.trace.label_stages(torch)
for kind in ("entries", "metrics"):
    for f in sorted(os.listdir(os.path.join(harness.BENCH_DIR, kind))):
        if f.endswith(".py") and f != "__init__.py":
            harness.load_module(kind, f[:-3])
print(harness.forbidden_loaded())
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    from benchmark import harness

    monkeypatch.setitem(sys.modules, "jaxlike_package", sys)
    assert "jaxlike_package" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_loaded()

"""The measurement path never falls back to the CPU: without a card a run
exits with a code other than 0 and prints no result, also from a directory
that holds only BENCHMARK.json and the benchmark's folder."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

ARGS = ["--workload", "i3d_crowd11.probs_b48", "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"]


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def _run(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS], cwd=cwd, capture_output=True, text=True,
                          env=env, timeout=300)


def test_no_card_no_result(no_card):
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_measure_raises_without_the_card_in_main(no_card):
    from benchmark import harness

    assert harness.main(ARGS, 0.0) != 0


def test_benchmark_folder_alone_gives_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""

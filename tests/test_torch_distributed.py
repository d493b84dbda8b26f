"""The port's processes over gloo on the CPU (`parallel.distributed`).

- Two worker processes (tests/torch_distributed_worker.py, which imports
  no JAX) join one gloo group at 127.0.0.1: each sees 2 processes, their
  `my_member_assignments(5)` are disjoint and cover the 20 members in
  JAX's order, and an all-reduce of rank + 1 reads 3.0 in both
  (tests/test_distributed_multiprocess.py:30-80).
- The cross-process data-parallel step (tests/_distributed_worker.py:68-113):
  two workers, each holding half of a global batch of 8 on 2 CPU
  positions, take one step of a width-0.125 R3D-18 in float64 with augment
  on; both end with the same weights bit for bit, equal (atol 1e-9) to the
  one-process step on the whole batch, and the same loss.
- The fan-out (tests/test_distributed_multiprocess.py:85-176 at a size
  tier-1 affords): two workers train their members of a 3-fold width-0.125
  C3D experiment into one work dir; every member leaves a best checkpoint
  and a history, and this process caches every test fold's probabilities
  from the union and fuses them with SUM.
- The kill-and-recover drill (tests/test_distributed_multiprocess.py:
  179-273, `slow` as there): of two fan-out workers, one is killed once it
  has finished its first member and started its second;
  `launch_ensemble_training(recover=True)`
  retrains exactly the pending members and never a finished one, and a
  second recover finds nothing.

Workers are started with `subprocess` (never forked), a group waits at
most 60 s for its peer and each `communicate` 120 s, so a hang fails the
test.  torch and the port are imported by fixtures
(tests/torch_port_memory.py).
"""

import json
import os
import signal
import socket
import subprocess
import sys

import jax  # noqa: F401 (JAX on the CPU before the port's fixtures import torch)
import numpy as np
import pytest

from crowded_scenes_ensemble_classification_tpu.core.config import split_pairs as j_split_pairs
from crowded_scenes_ensemble_classification_tpu.data import synthetic as jsynthetic
from torch_port_memory import release_heap_after_module, torch  # noqa: F401 (fixtures)

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_distributed_worker.py")
TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(mode: str, *extra: str) -> dict:
    """Two workers of `mode` in one group → their JSON records by rank."""
    coordinator = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, WORKER, mode, coordinator, "2", str(rank), *extra], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for rank in range(2)]
    records = {}
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, f"worker failed:\nstdout={out}\nstderr={err[-4000:]}"
            record = json.loads(out.strip().splitlines()[-1])
            records[record["process_id"]] = record
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert set(records) == {0, 1}
    return records


def _pairs(record) -> set:
    return {tuple(p) for p in record["assignments"]}


def test_two_process_group(torch):
    records = _run_workers("smoke")
    for r in records.values():
        assert r["processes"] == 2 and r["multi_process"] and r["all_reduce"] == pytest.approx(3.0)
    assert _pairs(records[0]).isdisjoint(_pairs(records[1]))
    assert _pairs(records[0]) | _pairs(records[1]) == set(j_split_pairs(5))
    merged = [None] * 20  # the round-robin over JAX's split_pairs order
    merged[0::2], merged[1::2] = (map(tuple, records[r]["assignments"]) for r in (0, 1))
    assert merged == j_split_pairs(5)


def test_two_process_member_fanout(torch, tmp_path):
    """Each process trains its `my_member_assignments(3)` members; the
    union is every member's checkpoint and history, and the evaluator here
    fuses it."""
    import torch_distributed_worker as worker

    from crowded_scenes_ensemble_classification_tpu_torch import orchestration as orch
    from crowded_scenes_ensemble_classification_tpu_torch.data.table import ClipTable
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.evaluate import evaluate_ensembles
    from crowded_scenes_ensemble_classification_tpu_torch.train.checkpoints import best_exists

    df = jsynthetic.generate_synthetic_dataset(str(tmp_path / "data"), num_scenes=9, clips_per_scene=3,
                                               num_classes=worker.CLASSES, num_frames=16, hw=worker.STAGING,
                                               as_videos=False)
    df.to_csv(tmp_path / "clips.csv", index=False)
    config = worker.fanout_config()
    layout = orch.prepare_ensemble(config, ClipTable.read_csv(str(tmp_path / "clips.csv")), str(tmp_path / "work"),
                                   device="cpu")
    records = _run_workers("fanout", layout.root)
    a0, a1 = _pairs(records[0]), _pairs(records[1])
    assert a0.isdisjoint(a1) and a0 | a1 == set(j_split_pairs(worker.FOLDS))
    for r in records.values():
        assert r["all_reduce"] == pytest.approx(3.0)
        assert [x[:2] for x in r["trained"]] == r["assignments"]
        assert all(np.isfinite(x[2]) for x in r["trained"])
    for t, v in j_split_pairs(worker.FOLDS):
        assert best_exists(layout.checkpoint_dir(config, t, v)), (t, v)
        assert os.path.exists(layout.history_path(config, t, v)), (t, v)

    bundle = worker.tiny_c3d(0, trainable=False)
    kw = dict(bundle=bundle, staging_hw=worker.STAGING, num_workers=2, input_scale=1 / 255.0, device="cpu")
    for t in range(worker.FOLDS):
        orch.cache_probabilities(config, layout, t, "test", **kw)
    res = evaluate_ensembles(orch.make_prob_provider(config, layout, **kw), worker.FOLDS, "SUM",
                             name=config.subfolder_name(), device="cpu")
    assert np.isfinite(res.mean_accuracy) and len(res.folds) == worker.FOLDS
    assert all(f.predictions.shape[0] > 0 for f in res.folds)


def test_two_process_data_parallel_step(torch):
    """Both processes' weights after the cross-process step are the same
    bytes and equal the one-process step on the global batch."""
    records = _run_workers("dataparallel")
    steps = [records[r]["step"] for r in (0, 1)]
    assert steps[0]["digest"] == steps[1]["digest"]
    for s in steps:
        assert s["max_abs_diff"] <= 1e-9, s
        assert s["loss"] == pytest.approx(s["one_process_loss"], abs=1e-6)
    assert steps[0]["loss"] == steps[1]["loss"]


@pytest.mark.slow
def test_kill_and_recover_retrains_exactly_the_pending(torch, tmp_path, monkeypatch):
    """Worker B is killed as soon as it has finished its first member and
    started its second (the signal lands while it trains it); recovery
    retrains exactly the
    members B left pending, leaves every finished member's artifacts
    untouched, and a second recovery finds nothing."""
    import time

    import torch_distributed_worker as worker

    from crowded_scenes_ensemble_classification_tpu_torch import orchestration as orch
    from crowded_scenes_ensemble_classification_tpu_torch.data.table import ClipTable

    df = jsynthetic.generate_synthetic_dataset(str(tmp_path / "data"), num_scenes=9, clips_per_scene=3,
                                               num_classes=worker.CLASSES, num_frames=16, hw=worker.STAGING,
                                               as_videos=False)
    df.to_csv(tmp_path / "clips.csv", index=False)
    config = worker.fanout_config()
    layout = orch.prepare_ensemble(config, ClipTable.read_csv(str(tmp_path / "clips.csv")), str(tmp_path / "work"),
                                   device="cpu")
    pairs = j_split_pairs(worker.FOLDS)
    members_a, members_b = pairs[:3], pairs[3:]
    sentinels = tmp_path / "sentinels"
    sentinels.mkdir()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}

    def spawn(members):  # a process group each: the interpreter may run under a launcher process
        return subprocess.Popen([sys.executable, WORKER, "recover", layout.root, json.dumps(members), str(sentinels)],
                                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                start_new_session=True)

    proc_a, proc_b = spawn(members_a), spawn(members_b)
    try:
        second, t0 = sentinels / "started_{}_{}".format(*members_b[1]), time.time()
        while not second.exists():
            assert time.time() - t0 < 600, "worker B never started its second member"
            assert proc_b.poll() is None, proc_b.communicate()[1]
            time.sleep(0.2)
        os.killpg(proc_b.pid, signal.SIGKILL)
        proc_b.wait(timeout=60)
        out, err = proc_a.communicate(timeout=600)
        assert proc_a.returncode == 0, f"worker A failed:\nstdout={out}\nstderr={err}"
    finally:
        for p in (proc_a, proc_b):
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()

    pending = orch.pending_members(config, layout)
    assert members_b[1] in pending and set(pending) <= set(members_b[1:])
    done = [p for p in pairs if p not in pending]
    mtimes = {p: os.path.getmtime(layout.history_path(config, *p)) for p in done}
    # members start from the tiny C3D of their seed, as the workers' do
    monkeypatch.setattr(orch, "build_with_condition", lambda config, seed=0, **_: (
        lambda b: (b, b.module.state_dict()))(worker.tiny_c3d(seed, trainable=True)))
    kw = dict(input_scale=1 / 255.0, staging_hw=worker.STAGING, num_workers=2, device="cpu")
    res = orch.launch_ensemble_training(config, None, layout.root, recover=True, **kw)
    assert set(res) == set(pending)
    assert all(orch.member_is_complete(config, layout, t, v) for t, v in pairs)
    assert {p: os.path.getmtime(layout.history_path(config, *p)) for p in done} == mtimes
    assert orch.launch_ensemble_training(config, None, layout.root, recover=True, **kw) == {}

"""The yardstick's arithmetic on made-up records: rates and the tail over
all batches, the union of device intervals and the idle gaps, bounds and
shares, the check's sample and numbers."""

from __future__ import annotations

import math
import types

import pytest
import torch

from benchmark import check, flops, peaks, readers, trace
from conftest import load


def _run(record, summary=None, config=None):
    return types.SimpleNamespace(record=record, summary=summary, config=config or load("configs", "i3d_crowd11"),
                                 traffic={}, cell={}, setup_s=1.0)


def _probs_record(done_s, issue_s, window_s=10.0, batch=4):
    return {"window_s": window_s, "clips_per_batch": batch, "host_s": [0.01] * len(done_s),
            "batches": [{"k": i, "issue_s": a, "done_s": d} for i, (a, d) in enumerate(zip(issue_s, done_s))]}


def test_rate_counts_only_batches_answered_inside_the_window():
    rec = _probs_record(done_s=[1.0, 2.0, 9.9, 10.1], issue_s=[0.0, 0.5, 9.0, 9.5])
    assert readers.infer_clips_per_s(_run(rec)) == pytest.approx(3 * 4 / 10.0)


def test_p95_is_nearest_rank_over_all_batches():
    lat = [0.1] * 95 + [1.0] * 5
    rec = _probs_record(done_s=[i + x for i, x in enumerate(lat)], issue_s=list(range(100)), window_s=200.0)
    assert readers.batch_ms_p95(_run(rec)) == pytest.approx(100.0)
    rec = _probs_record(done_s=[i + x for i, x in enumerate(lat[:94] + [1.0] * 6)], issue_s=list(range(100)),
                        window_s=200.0)
    assert readers.batch_ms_p95(_run(rec)) == pytest.approx(1000.0)


def test_p95_needs_some_batches():
    rec = _probs_record(done_s=[1.0, 2.0], issue_s=[0.0, 1.0])
    assert readers.batch_ms_p95(_run(rec)) is None


def test_train_rate_over_the_whole_window():
    rec = {"window_s": 12.5, "steps": 50, "clips_per_step": 64, "host_s": [0.1] * 50}
    assert readers.train_clips_per_s(_run(rec)) == pytest.approx(256.0)
    assert readers.infer_clips_per_s(_run(rec)) is None


def test_busy_is_the_union_of_intervals():
    assert trace.busy_us([(0, 10), (5, 15), (20, 30), (21, 22)]) == 25
    assert trace.busy_us([]) == 0


def test_idle_gaps_cover_what_no_interval_does():
    assert trace.idle_gaps([(2, 4), (3, 5), (8, 9)], 0, 10) == [(0, 2), (5, 8), (9, 10)]


def test_bound_takes_the_larger_of_operations_and_bytes():
    assert peaks.bound_s(989e12, 0.0, "bfloat16") == pytest.approx(1.0)
    assert peaks.bound_s(1.0, 3.35e12, "bfloat16") == pytest.approx(1.0)
    assert peaks.bound_s(1979e12, 0.0, "int8") == pytest.approx(1.0)
    assert peaks.share_pct(0.5, 2.0) == pytest.approx(25.0)
    assert peaks.share_pct(0.5, 0.0) is None


def test_pool_bound_at_the_published_shapes():
    cfg = load("configs", "i3d_crowd11")
    # 6,250,048 elements of pool input a clip: 400 MB in and out at B=16 in bf16.
    per_member_clip = 9 * flops.pool_bytes_per_launch(cfg, ["I3D"])
    assert per_member_clip == pytest.approx(4 * 6_250_048)
    assert 9 * flops.pool_bytes_per_launch(cfg, ["I3D"], backward=True) == pytest.approx(6 * 6_250_048)


def test_roofline_and_mfu_readers():
    cfg = load("configs", "i3d_crowd11")
    launches = 36 * 10
    per_launch = flops.pool_bytes_per_launch(cfg, ["I3D"])
    summary = {"busy_s": 9.0, "window_s": 10.0, "device_s": 9.5, "stage_s": {"decode": 1.0, "member": 8.0},
               "kernel_s": {"maxpool3x3x3_kernel<bf16>": launches * 48 * per_launch / 3.35e12 * 2},
               "launches": {"maxpool3x3x3_kernel<bf16>": launches}}
    rec = _probs_record(done_s=[1.0] * 10, issue_s=[0.0] * 10, batch=48)
    run = _run(rec, summary, cfg)
    assert readers.pool_roofline_pct(run, "batches", backward=False) == pytest.approx(50.0)
    assert readers.idle_pct(run, "batches") == pytest.approx(10.0)
    assert readers.frontend_ms(run, "batches") == pytest.approx(100.0)
    assert readers.members_ms(run, "batches") == pytest.approx(800.0)
    assert readers.mfu(run, "batches") == pytest.approx(100 * 480 * flops.ensemble_clip_flops(cfg) / (10.0 * 989e12))
    assert readers.pool_roofline_pct(run, "steps", backward=True) is None


def test_training_members_are_what_is_not_front_end_or_optimizer():
    summary = {"busy_s": 9.0, "window_s": 10.0, "device_s": 9.0,
               "stage_s": {"preprocess": 1.0, "optimizer": 0.5, "unlabeled": 7.0, "gather": 0.5}}
    rec = {"window_s": 10.0, "steps": 10, "clips_per_step": 64, "host_s": [0.1] * 10}
    assert readers.members_ms(_run(rec, summary), "steps") == pytest.approx(700.0)
    assert readers.frontend_ms(_run(rec, summary), "steps") == pytest.approx(150.0)


def test_sample_always_holds_the_last_batch():
    for seed in range(20):
        picks = check.sample_clips(seed, 7, 5, 4)
        assert len(set(picks)) == 4 and any(b == 6 for b, _ in picks)
        assert all(0 <= b < 7 and 0 <= r < 5 for b, r in picks)
    assert check.sample_clips(3, 7, 5, 4) == check.sample_clips(3, 7, 5, 4)


def test_probs_readings():
    ref = torch.tensor([[[0.7, 0.2, 0.1], [0.6, 0.3, 0.1]]])
    same = check.probs_readings(ref, torch.tensor([0]), ref)
    assert same["prob_err"] == same["fused_gap"] == same["prob_rms"] == same["logit_err"] == same["pred_err"] == 0.0
    assert same["clear_clips"] == 1.0
    r = check.probs_readings(ref + torch.tensor([0.0, 0.05, -0.05]), torch.tensor([1]), ref)
    assert r["prob_err"] == pytest.approx(0.05) and r["fused_gap"] == pytest.approx(0.8) and r["pred_err"] == 1.0
    assert r["prob_rms"] == pytest.approx(0.05 * (2 / 3) ** 0.5) and r["logit_err"] > 0
    scaled = torch.softmax(2.0 * ref.log(), -1)  # logits doubled: twice their centred norm
    assert check.probs_readings(scaled, torch.tensor([0]), ref)["logit_err"] == pytest.approx(1.0)
    tie = torch.tensor([[[0.45, 0.44, 0.11]]])
    near = torch.tensor([[[0.44, 0.45, 0.11]]])  # the tie flipped in the probabilities themselves
    assert check.probs_readings(near, torch.tensor([1]), tie)["pred_err"] == 0.0
    assert check.probs_readings(tie, torch.tensor([1]), tie)["pred_err"] == 1.0


def test_failed_answers():
    good = torch.full((2, 3, 4), 0.25)
    assert check.answers_failed(good) == 0
    bad = good.clone()
    bad[1, 2, 0] = float("nan")
    bad[0, 0, 0] = 0.5
    assert check.answers_failed(bad) == 2


def test_verdict_fails_a_missing_or_non_finite_number():
    v = check.verdict({"a": 0.1, "b": math.nan}, {"a": 0.2, "b": 1.0, "c": 1.0})
    assert [x["ok"] for x in v] == [True, False, False]


def test_leaf_gaps():
    from benchmark.reference import train

    ref = {"a": 1.0, "b": 2.0, "c": 4.0, "d": 1e-9}
    assert train.moved_leaves(ref) == ["a", "b", "c"]
    prog = {"a": 1.1, "b": 2.0, "c": 4.0, "d": 5.0}
    assert train.worst_leaf_gap(prog, ref, ["a", "b", "c"]) == pytest.approx(0.05)  # floored at the median, 2.0
    assert check.relative_gaps([1.0, 2.2], [1.0, 2.0]) == pytest.approx(0.1)


def test_trace_summary_charges_kernels_to_the_innermost_range():
    E = trace.Event
    ms = 1_000_000
    events = [
        E(False, "bench.step", 0, 100 * ms, 1, 1, 0),
        E(False, "member", 10 * ms, 80 * ms, 1, 2, 0),
        E(False, "max_pool_3x3x3_same", 20 * ms, 5 * ms, 1, 3, 0),
        E(False, "aten::conv3d", 40 * ms, 5 * ms, 1, 4, 0),
        E(False, "aten::add", 95 * ms, 1 * ms, 1, 5, 0),
        E(False, "aten::mm", 1 * ms, 1 * ms, 7, 6, 0),  # another thread, no range
        E(False, "cudaLaunchKernel", 41 * ms, 1 * ms, 1, 4, 4),
        E(True, "maxpool3x3x3_kernel<bf16>", 30 * ms, 10 * ms, 0, 0, 3),
        E(True, "conv_kernel", 45 * ms, 20 * ms, 0, 0, 4),
        E(True, "add_kernel", 96 * ms, 2 * ms, 0, 0, 5),
        E(True, "mm_kernel", 70 * ms, 5 * ms, 0, 0, 6),
        E(True, "salt_pepper_kernel", 80 * ms, 1 * ms, 0, 0, 99),  # linked to no op
    ]
    s = trace.summarize_events(events, {"member", "max_pool_3x3x3_same", "decode", "salt_pepper"}, 0.1)
    assert s["busy_s"] == pytest.approx(0.038)
    assert s["stage_s"] == pytest.approx({"max_pool_3x3x3_same": 0.010, "member": 0.020, "unlabeled": 0.007,
                                          "salt_pepper": 0.001})
    assert trace.kernel_stats(s, trace.POOL_KERNEL) == (pytest.approx(0.010), 1)
    assert s["idle_gaps"][0] == ["bench.step", pytest.approx(0.030)]  # 0 to 30 ms: the step had begun

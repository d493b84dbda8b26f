"""What the metric files under `benchmark/metrics/` compute, from a run's
record of its window (`loops`) and, in a traced run, the profile's summary
(`trace.summarize`).  A reader that finds nothing to read returns None and
the metric is left out of the result."""

from __future__ import annotations

import math
from typing import Optional

from . import flops, peaks, trace


def answered_in_window(run) -> list:
    """The batches whose answers reached host memory inside the window."""
    return [b for b in run.record.get("batches", []) if b["done_s"] <= run.record["window_s"]]


def infer_clips_per_s(run) -> Optional[float]:
    if "batches" not in run.record:
        return None
    return len(answered_in_window(run)) * run.record["clips_per_batch"] / run.record["window_s"]


def batch_ms_p95(run) -> Optional[float]:
    """The 95th percentile (nearest rank) of issue-to-answer times over all
    batches answered in the window."""
    times = sorted(b["done_s"] - b["issue_s"] for b in answered_in_window(run))
    if len(times) < 20:
        return None
    return 1e3 * times[math.ceil(0.95 * len(times)) - 1]


def train_clips_per_s(run) -> Optional[float]:
    if "steps" not in run.record:
        return None
    return run.record["steps"] * run.record["clips_per_step"] / run.record["window_s"]


def host_ms(run, kind: str) -> Optional[float]:
    """Host milliseconds a step call, over all the window's calls."""
    if kind not in run.record or not run.record["host_s"]:
        return None
    return 1e3 * sum(run.record["host_s"]) / len(run.record["host_s"])


def _steps(run) -> int:
    return len(run.record["host_s"])


def frontend_ms(run, kind: str) -> Optional[float]:
    """Device ms a step under the front end's ranges."""
    if run.summary is None or kind not in run.record:
        return None
    return 1e3 * trace.layer_s(run.summary, trace.FRONTEND) / _steps(run)


def members_ms(run, kind: str) -> Optional[float]:
    """Device ms a step under the members' ranges; in training all device
    time outside the front end's and the optimizer's (the backward pass
    runs on autograd's thread, under no range)."""
    if run.summary is None or kind not in run.record:
        return None
    s = run.summary
    if kind == "steps":
        total = s["device_s"] - trace.layer_s(s, trace.FRONTEND) - trace.layer_s(s, trace.OPTIMIZER)
    else:
        total = trace.layer_s(s, trace.MEMBERS)
    return 1e3 * total / _steps(run)


def idle_pct(run, kind: str) -> Optional[float]:
    if run.summary is None or kind not in run.record:
        return None
    return 100.0 * (1.0 - run.summary["busy_s"] / run.summary["window_s"])


def pool_roofline_pct(run, kind: str, backward: bool) -> Optional[float]:
    """The 3x3x3/1 max pool's (or its gradient's) bound over its device
    time, both summed over the traced window."""
    if run.summary is None or kind not in run.record:
        return None
    secs, launches = trace.kernel_stats(run.summary, trace.POOL_BWD_KERNEL if backward else trace.POOL_KERNEL)
    if not launches:
        return None
    families = list(run.config["members"]) if kind == "batches" else [run.config["train"]["family"]]
    clips = run.record["clips_per_batch"] if kind == "batches" else run.record["clips_per_step"]
    nbytes = launches * clips * flops.pool_bytes_per_launch(run.config, families, backward)
    return peaks.share_pct(peaks.bound_s(0.0, nbytes, "bfloat16"), secs)


def mfu(run, kind: str) -> Optional[float]:
    """FLOPs of the clips the window completed over (window × the peak of
    the precision the convs run in)."""
    if run.summary is None or kind not in run.record:
        return None
    if kind == "batches":
        clips = len(answered_in_window(run)) * run.record["clips_per_batch"]
        work, precision = clips * flops.ensemble_clip_flops(run.config), run.config["precision"]
    else:
        clips = run.record["steps"] * run.record["clips_per_step"]
        work, precision = clips * flops.train_clip_flops(run.config), run.config["train"]["precision"]
    return 100.0 * work / (run.record["window_s"] * peaks.FLOPS_PER_S[precision])

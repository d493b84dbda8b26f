"""Observability: a structured metric stream, stage timers, a profiler hook.

Counterpart of `crowded_scenes_ensemble_classification_tpu/utils/metrics.py`
(lines 1-93):

- `MetricsLogger`: an append-only JSONL event stream (one object per line:
  epoch metrics, stage timings, members done), the JAX records key for key;
- `StageTimer`: wall-clock time of named stages with items/s.  A stage may
  name the CUDA device its work runs on: the stage then ends in
  `torch.cuda.synchronize(device)`, so queued kernels count in the stage
  that launched them (JAX dispatch is asynchronous too; there the caller
  blocks on the outputs);
- `profile_trace`: a `torch.profiler` trace of the CPU and the card,
  written as a Chrome trace under `log_dir`.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Optional

import torch


class MetricsLogger:
    """Append-only JSONL metrics file.  Safe to re-open across runs."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, event: str, **fields: Any) -> Dict[str, Any]:
        record = {"t": time.time(), "event": event, **fields}
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        return record

    def read(self):
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]


class StageTimer:
    """Accumulates wall-clock seconds per named stage; `rate(name)` gives
    items/s."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0, device=None):
        """Time the block; with a CUDA `device`, synchronize it at both ends."""
        sync = device is not None and torch.device(device).type == "cuda"
        if sync:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + items

    def seconds(self, name: str) -> float:
        return self.totals.get(name, 0.0)

    def rate(self, name: str) -> float:
        """items/s of the stage (0 when untimed)."""
        t = self.totals.get(name, 0.0)
        return self.counts.get(name, 0) / t if t > 0 else 0.0

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {"seconds": self.totals[name], "items": self.counts.get(name, 0), "items_per_sec": self.rate(name)}
            for name in self.totals
        }


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """`torch.profiler` trace of the block (the CPU, and the card when one
    is present), exported to `log_dir/trace.json`; a no-op when log_dir is
    None.  Yields the profiler (None when off)."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

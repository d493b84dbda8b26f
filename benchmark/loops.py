"""The measured windows: one loop for the probability entries, one for
training.  Both run on whatever device the step runs on; only a CUDA run
is a measurement (`harness` refuses to measure without a card).

`probs_window` keeps `in_flight` batches in flight (two, as a prefetching
caller of the probabilities path does: it issues batch k+1, then waits for
batch k).
Batch k's probabilities and predictions go to pinned host memory by a
`non_blocking` copy enqueued right after the batch is issued, with an
event recorded after the copy; a batch is complete when its event has
fired.  Issuing stops at the end of the window; what is still in flight is
drained (its answers are checked, but it does not count in the window).

`train_window` issues steps back to back until the window's time is up and
ends in `torch.cuda.synchronize()`: the window is all of that time.

Each step call is timed by the host clock in a `bench.step` range, with
nothing synchronised inside it.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Callable, Dict, List

import torch

STEP_RANGE = "bench.step"


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def probs_window(step: Callable[[int], tuple], seconds: float, device: torch.device,
                 tracing=contextlib.nullcontext, in_flight: int = 2) -> Dict:
    """step(k) → ((M, B, C) probabilities, (B,) predictions) on the device,
    for k = 0, 1, ... → {"window_s": seconds, "elapsed_s": to the last
    answer drained, "batches": [{"k", "issue_s", "done_s", "probs",
    "preds"}] in order of k, "host_s": [seconds of each call]}."""
    cuda = device.type == "cuda"
    pending: collections.deque = collections.deque()
    buffers: List = []
    ring = in_flight + 2
    done, host_s = [], []

    def complete(entry) -> None:
        k, issue_s, event, hp, hq = entry
        if event is not None:
            event.synchronize()
        done.append({"k": k, "issue_s": issue_s, "done_s": time.perf_counter() - t0,
                     "probs": hp.clone(), "preds": hq.clone()})

    with tracing():
        sync(device)
        t0 = time.perf_counter()
        k = 0
        while True:
            ti = time.perf_counter()
            with torch.profiler.record_function(STEP_RANGE):
                probs, preds = step(k)
            host_s.append(time.perf_counter() - ti)
            if len(buffers) < ring:
                buffers.append((torch.empty(probs.shape, dtype=probs.dtype, pin_memory=cuda),
                                torch.empty(preds.shape, dtype=preds.dtype, pin_memory=cuda)))
            hp, hq = buffers[k % ring]
            hp.copy_(probs, non_blocking=cuda)
            hq.copy_(preds, non_blocking=cuda)
            event = None
            if cuda:
                event = torch.cuda.Event()
                event.record()
            pending.append((k, ti - t0, event, hp, hq))
            k += 1
            stop = time.perf_counter() - t0 >= seconds
            while len(pending) > (0 if stop else in_flight - 1):
                complete(pending.popleft())
            if stop:
                break
        elapsed_s = time.perf_counter() - t0
    return {"window_s": float(seconds), "elapsed_s": elapsed_s, "batches": done, "host_s": host_s}


def train_window(step: Callable[[], torch.Tensor], seconds: float, device: torch.device,
                 tracing=contextlib.nullcontext) -> Dict:
    """step() → the step's loss (a device scalar), called back to back →
    {"window_s", "steps", "losses": [device scalars], "host_s"}."""
    losses, host_s = [], []
    with tracing():
        sync(device)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            ti = time.perf_counter()
            with torch.profiler.record_function(STEP_RANGE):
                losses.append(step())
            host_s.append(time.perf_counter() - ti)
        sync(device)
        window_s = time.perf_counter() - t0
    return {"window_s": window_s, "elapsed_s": window_s, "steps": len(losses), "losses": losses, "host_s": host_s}

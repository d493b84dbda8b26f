"""Reading the device's work from a `torch.profiler` trace of the window.

The ranges are the benchmark's own: `label_stages` wraps the program's
functions from outside in `record_function` ranges (the program has none
of its own at its layer boundaries yet), and the entries open a
`bench.step` range around each step call.  Each device interval (kernel,
memcpy, memset) is charged to the innermost range open on the launching
op's thread when that op started; the program's own kernels, which may
reach the profiler through ctypes with no op linked, are charged by name
(`OWN_KERNELS`).  Device time under no range is `unlabeled`: in training
that is the backward pass, which runs on autograd's thread.

`summarize` gives what the per-layer metrics read: the window's wall and
the union of device intervals (busy), device seconds by range and by
kernel name, launches by kernel, and, for the result's breakdown, the
device ops that took most time and the longest idle gaps, each named by
the innermost host range open when the gap began.
"""

from __future__ import annotations

import collections
import functools
from typing import Dict, Iterable, List, NamedTuple, Set, Tuple

FRONTEND = ("decode", "augment", "salt_pepper", "s2d_stage", "gather", "preprocess")
MEMBERS = ("member", "two_stream", "c3d", "r3d", "stem", "max_pool_3x3x3_same", "strided_pool", "int8_conv3d",
           "quantize_int8", "max_pool_3x3x3_same_backward")
OPTIMIZER = ("optimizer",)
STEP = "bench.step"
# Kernel-name fragments of the program's own kernels → the range they run under.
OWN_KERNELS = {"maxpool3x3x3_kernel": "max_pool_3x3x3_same", "salt_pepper_kernel": "salt_pepper",
               "stem_bf16_kernel": "stem", "maxpool3_bwd_": "max_pool_3x3x3_same_backward",
               "int8_conv3d_": "int8_conv3d", "int8_dequant_kernel": "int8_conv3d",
               "quantize_int8_": "quantize_int8"}
POOL_KERNEL = "maxpool3x3x3_kernel"
POOL_BWD_KERNEL = "maxpool3_bwd_"


def busy_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def idle_gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    gaps, end = [], lo
    for s, e in sorted(intervals):
        if s > end:
            gaps.append((end, min(s, hi)))
        end = max(end, e)
    if end < hi:
        gaps.append((end, hi))
    return [(a, b) for a, b in gaps if b > a]


def label_stages(torch) -> Set[str]:
    """Wrap the program's layer functions in record_function ranges; returns
    the range names."""
    import crowded_scenes_ensemble_classification_tpu_torch.ensemble.members as members_mod
    import crowded_scenes_ensemble_classification_tpu_torch.ensemble.pipeline as pipeline_mod
    import crowded_scenes_ensemble_classification_tpu_torch.models.c3d as c3d_mod
    import crowded_scenes_ensemble_classification_tpu_torch.models.common as common_mod
    import crowded_scenes_ensemble_classification_tpu_torch.models.i3d as i3d_mod
    import crowded_scenes_ensemble_classification_tpu_torch.models.r3d as r3d_mod
    import crowded_scenes_ensemble_classification_tpu_torch.models.two_stream_i3d as ts_mod
    import crowded_scenes_ensemble_classification_tpu_torch.ops.augment as augment_mod
    import crowded_scenes_ensemble_classification_tpu_torch.train.engine as engine_mod
    import crowded_scenes_ensemble_classification_tpu_torch.train.state as state_mod

    def wrap(owner, attr, name):
        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def ranged(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        setattr(owner, attr, ranged)
        return name

    return {
        wrap(pipeline_mod, "i420_to_bgr_u8", "decode"),
        wrap(pipeline_mod, "crowd11_augment_from_decisions", "augment"),
        wrap(augment_mod, "salt_pepper", "salt_pepper"),
        wrap(members_mod, "s2d_stem_stage", "s2d_stage"),
        wrap(pipeline_mod, "s2d_stem_stage", "s2d_stage"),
        wrap(common_mod.PrestagedS2DStemConvBN, "forward", "stem"),
        wrap(i3d_mod.I3D, "forward", "member"),
        wrap(ts_mod.TwoStreamI3D, "forward", "two_stream"),
        wrap(c3d_mod.C3D, "forward", "c3d"),
        wrap(r3d_mod.R3D, "forward", "r3d"),
        wrap(i3d_mod, "max_pool_3x3x3_same", "max_pool_3x3x3_same"),
        wrap(i3d_mod, "max_pool_3d", "strided_pool"),
        wrap(pipeline_mod, "fuse_predictions", "fusion"),
        wrap(engine_mod, "_gather", "gather"),
        wrap(engine_mod, "_preprocess", "preprocess"),
        wrap(state_mod.KerasSGD, "step", "optimizer"),
        wrap(state_mod.KerasAdam, "step", "optimizer"),
    }


class Event(NamedTuple):
    """One event of the trace: on the host (`device` False: an op, a range
    or a runtime call, with its thread and correlation id) or on the card
    (a kernel, memcpy or memset, with the correlation id of the host op that
    launched it in `linked`)."""

    device: bool
    name: str
    start_ns: int
    dur_ns: int
    thread: int
    corr: int
    linked: int


def kineto_events(prof) -> List[Event]:
    """The profile's raw events, read without building PyTorch's event tree
    (which takes minutes on a window of half a million kernels)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        device = e.device_type() == DeviceType.CUDA
        if device and e.is_user_annotation():
            continue
        out.append(Event(device, e.name(), e.start_ns(), e.duration_ns(), e.start_thread_id(), e.correlation_id(),
                         e.linked_correlation_id()))
    return out


def _innermost(intervals: List[Tuple[int, int, str]], queries: List[Tuple[int, int]]) -> Dict[int, str]:
    """For (time, id) queries, the name of the innermost of the nested
    (start, end, name) intervals open at that time (absent: none open)."""
    intervals = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    out, stack, at = {}, [], 0
    for t, qid in sorted(queries):
        while at < len(intervals) and intervals[at][0] <= t:
            while stack and stack[-1][1] <= intervals[at][0]:
                stack.pop()
            stack.append(intervals[at])
            at += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        if stack:
            out[qid] = stack[-1][2]
    return out


def summarize(prof, labels: Set[str], window_s: float) -> Dict:
    """`summarize_events` of a profile."""
    return summarize_events(kineto_events(prof), labels, window_s)


def summarize_events(events: List[Event], labels: Set[str], window_s: float) -> Dict:
    """What the per-layer metrics and the breakdown read from the window's
    events (see the module docstring).  Raises if the card did no work, or
    more than the wall."""
    ranges = set(labels) | {STEP}
    device = [e for e in events if e.device and e.name not in ranges]
    if not device:
        raise RuntimeError("the profiler recorded no device activity")
    intervals = [(e.start_ns, e.start_ns + e.dur_ns) for e in device]
    busy_s = busy_us(intervals) / 1e9
    if busy_s > window_s * 1.001:
        raise RuntimeError(f"device busy {busy_s:.3f} s exceeds the traced window {window_s:.3f} s")
    by_name: Dict[str, float] = collections.defaultdict(float)
    launches: Dict[str, int] = collections.defaultdict(int)
    for e in device:
        by_name[e.name] += e.dur_ns / 1e9
        launches[e.name] += 1
    host = [e for e in events if not e.device]
    ops = {e.corr: e for e in host if e.linked == 0}  # ops; runtime calls carry a link of their own
    by_thread: Dict[int, list] = collections.defaultdict(list)
    for e in host:
        if e.name in labels:
            by_thread[e.thread].append((e.start_ns, e.start_ns + e.dur_ns, e.name))
    queries: Dict[int, list] = collections.defaultdict(list)
    for i, e in enumerate(device):
        op = ops.get(e.linked)
        if op is not None:
            queries[op.thread].append((op.start_ns, i))
    stage_of: Dict[int, str] = {}
    for thread, qs in queries.items():
        found = _innermost(by_thread.get(thread, []), qs)
        stage_of.update({i: found.get(i, "unlabeled") for _, i in qs})
    stages: Dict[str, float] = collections.defaultdict(float)
    for i, e in enumerate(device):
        stage = stage_of.get(i) or next((st for frag, st in OWN_KERNELS.items() if frag in e.name), "unattributed")
        stages[stage] += e.dur_ns / 1e9
    steps = [e for e in host if e.name == STEP]
    main = steps[0].thread if steps else None
    lo = min([s for s, _ in intervals] + [e.start_ns for e in steps])
    hi = max([t for _, t in intervals] + [e.start_ns + e.dur_ns for e in steps])
    gaps = sorted(idle_gaps(intervals, lo, hi), key=lambda g: g[0] - g[1])[:10]
    named = _innermost([(e.start_ns, e.start_ns + e.dur_ns, e.name) for e in host if e.thread == main],
                       [(a, i) for i, (a, _) in enumerate(gaps)])
    return {
        "window_s": window_s,
        "busy_s": busy_s,
        "device_s": sum(by_name.values()),
        "stage_s": dict(stages),
        "kernel_s": dict(by_name),
        "launches": dict(launches),
        "device_ops": [[n[:160], s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[named.get(i, "no host range open")[:160], (b - a) / 1e9] for i, (a, b) in enumerate(gaps)],
    }


def layer_s(summary: Dict, names: Tuple[str, ...]) -> float:
    return sum(s for st, s in summary["stage_s"].items() if st in names)


def kernel_stats(summary: Dict, fragment: str) -> Tuple[float, int]:
    """(device seconds, launches) of the kernels whose name holds `fragment`."""
    secs = sum(s for n, s in summary["kernel_s"].items() if fragment in n)
    count = sum(c for n, c in summary["launches"].items() if fragment in n)
    return secs, count


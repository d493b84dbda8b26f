#!/usr/bin/env python3
"""Where the device time of the PyTorch port's main path goes, on one CUDA card.

    python3 tools/profile_step_torch.py [--out chiprun_out/profile_step_torch.json]

At B=16 (chip_smoke.py's batch) and at B=48 it builds chip_smoke.py's
configuration (4 full-width random-init I3D members in bf16, 20×224² clips
from 256² I420 rows), warms up, times 3 calls of `resident_ensemble_step`
without the profiler, then times and profiles 3 more under torch.profiler.

- Busy time is the union of the intervals of every kernel, memcpy and
  memset on the card, so it cannot exceed the wall clock of the profiled
  steps (the script fails if it does).  Idle share = 1 − busy / wall.
- Each device interval is charged to a stage: the innermost of the ranges
  this script opens around the pipeline's parts (decode, augment,
  salt_pepper, s2d_stage, stem, member, max_pool_3x3x3_same, strided_pool,
  fusion), joined with the outermost aten op under that range which
  launched it (`member/aten::conv3d`, `member/aten::batch_norm`, ...).
  The port's own kernels that reach the profiler with no op linked are
  charged to their wrapper's stage by kernel name; other device time no op
  claims is reported as unattributed.  Shares are of the busy time.

Prints a table per batch size and writes the full records as JSON to --out.
Needs one card; imports no JAX.
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FRAMES, SIZE, STAGING, MEMBERS, CLASSES = 20, 224, 256, 4, 11  # as in chip_smoke.py
BATCHES, STEPS = (16, 48), 3
OWN_KERNELS = {"maxpool3x3x3_kernel": "max_pool_3x3x3_same", "salt_pepper_kernel": "salt_pepper"}


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def label_stages(torch):
    """Wrap the pipeline's parts in record_function ranges; returns the
    range names."""
    import crowded_scenes_ensemble_classification_tpu_torch.ensemble.members as members_mod
    import crowded_scenes_ensemble_classification_tpu_torch.ensemble.pipeline as pipeline_mod
    import crowded_scenes_ensemble_classification_tpu_torch.models.common as common_mod
    import crowded_scenes_ensemble_classification_tpu_torch.models.i3d as i3d_mod
    import crowded_scenes_ensemble_classification_tpu_torch.ops.augment as augment_mod

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
        wrap(common_mod.PrestagedS2DStemConvBN, "forward", "stem"),
        wrap(i3d_mod.I3D, "forward", "member"),
        wrap(i3d_mod, "max_pool_3x3x3_same", "max_pool_3x3x3_same"),
        wrap(i3d_mod, "max_pool_3d", "strided_pool"),
        wrap(pipeline_mod, "fuse_predictions", "fusion"),
    }


def stage_of(event, labels) -> str:
    """Innermost label range above `event`, joined with the outermost aten
    op between the two."""
    outer_op = None
    while event is not None:
        if event.name in labels:
            return f"{event.name}/{outer_op}" if outer_op else event.name
        if event.name.startswith("aten::"):
            outer_op = event.name
        event = event.cpu_parent
    return f"unlabeled/{outer_op}"


def breakdown(events, labels, wall_s: float, steps: int) -> dict:
    from torch.autograd import DeviceType

    device = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in labels]
    if not device:
        raise RuntimeError("the profiler recorded no device activity")
    busy = busy_us((e.time_range.start, e.time_range.end) for e in device) / 1e3
    kernel_sum = sum(e.time_range.end - e.time_range.start for e in device) / 1e3
    wall = wall_s * 1e3
    if busy > wall:
        raise RuntimeError(f"device busy {busy:.3f} ms exceeds the wall clock {wall:.3f} ms")

    by_name = collections.defaultdict(float)
    for e in device:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    stages = collections.defaultdict(float)
    claimed = collections.defaultdict(float)
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        for k in e.kernels:
            if k.name not in labels:
                stages[stage_of(e, labels)] += k.duration / 1e3
                claimed[k.name] += k.duration / 1e3
    # Launches from the port's ctypes wrappers may reach the profiler with
    # no op linked; their kernels are known by name.
    for name, ms in by_name.items():
        if ms - claimed[name] > 1e-6:
            stage = next((s for k, s in OWN_KERNELS.items() if k in name), "unattributed")
            stages[stage] += ms - claimed[name]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return {
        "wall_ms_per_step": wall / steps,
        "busy_ms_per_step": busy / steps,
        "idle_share": 1.0 - busy / wall,
        "device_interval_sum_ms_per_step": kernel_sum / steps,
        "stages": {
            name: {"ms_per_step": ms / steps, "share_of_busy": ms / busy}
            for name, ms in sorted(stages.items(), key=lambda kv: -kv[1])
        },
        "top_device_names": [{"name": n[:120], "ms_per_step": ms / steps} for n, ms in top],
    }


def profile_batch(batch: int, steps: int, labels, torch, np) -> dict:
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.pipeline import (
        resident_ensemble_step,
    )
    from crowded_scenes_ensemble_classification_tpu_torch.models.common import cast_for_inference
    from crowded_scenes_ensemble_classification_tpu_torch.models.i3d import I3D

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2)
    members = [
        cast_for_inference(I3D(CLASSES, frames=FRAMES, stem_prestaged=True, generator=gen).to(dev),
                           torch.bfloat16).eval()
        for _ in range(MEMBERS)
    ]
    ibytes = FRAMES * STAGING * STAGING * 3 // 2
    rows = np.random.default_rng(3).integers(0, 256, (steps * batch, ibytes), dtype=np.uint8)
    resident = torch.from_numpy(rows).to(dev)
    step_gen = torch.Generator().manual_seed(4)

    def run() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            resident_ensemble_step(members, resident, i, step_gen, batch_size=batch,
                                   frames=FRAMES, staging=STAGING, out_hw=(SIZE, SIZE))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run()  # warm-up: kernel build, cuDNN plans, allocator
    plain_s = run()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        wall_s = run()
    out = {"batch": batch, "steps": steps,
           "wall_ms_per_step_unprofiled": plain_s * 1e3 / steps,
           "clips_per_s_unprofiled": steps * batch / plain_s}
    out.update(breakdown(prof.events(), labels, wall_s, steps))
    del members, resident
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/profile_step_torch.json")
    args = ap.parse_args()

    import numpy as np
    import torch

    from crowded_scenes_ensemble_classification_tpu_torch.utils.device import require_cuda

    smi = require_cuda()
    print(smi)
    labels = label_stages(torch)
    results = []
    for batch in BATCHES:
        r = profile_batch(batch, STEPS, labels, torch, np)
        r["device"] = smi
        results.append(r)
        print(f"B={batch}: {r['clips_per_s_unprofiled']:.2f} clips/s unprofiled "
              f"({r['wall_ms_per_step_unprofiled']:.3f} ms/step); profiled wall {r['wall_ms_per_step']:.3f} "
              f"ms/step, device busy {r['busy_ms_per_step']:.3f} ms/step, idle share {r['idle_share']:.4f}")
        for name, s in r["stages"].items():
            if s["share_of_busy"] >= 1e-3:
                print(f"  {name:50s} {s['ms_per_step']:9.3f} ms/step  {100 * s['share_of_busy']:6.2f} %")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

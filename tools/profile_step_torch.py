#!/usr/bin/env python3
"""Where the device time of the PyTorch port's main path goes, on one CUDA card.

    python3 tools/profile_step_torch.py [--out chiprun_out/profile_step_torch.json]

At B=16 (chip_smoke.py's batch) and at B=48 it builds chip_smoke.py's
configuration (4 full-width random-init I3D members in bf16, 20×224² clips
from 256² I420 rows), warms up, times 3 calls of `resident_ensemble_step`
without the profiler, then times and profiles 3 more under torch.profiler.
Then, at B=16, the same for chip_smoke.py's per-member paths over uint8
20×224² batches at input scale 1/255: the unshared member forward with the
stem kernel (members from `build_model(stem_impl='pallas')`), the same
members in shared-staging form (cuDNN stem), and the loaded serving
artifact of the unshared forward.  Last, the resident training step
(`make_resident_train_step`, augment on, one trainable I3D computing in
bf16 on f32 master weights, 20×224² from 256² uint8 staging) at B=16 and
B=64, and the other families' resident train steps at chip_smoke.py's
train_zoo geometry (the JAX bench's, bench.py:624-720): C3D at B=32
(`train_c3d`), TwoStream-I3D at B=16 with turbo Farnebäck of its resident
gray pairs in the step, the `flow` stage (`train_twostream`), and R3D-18
at B=32 (`train_r3d18`).  Backward ops run on autograd's device thread,
outside the ranges this script opens, so they are charged to
`unlabeled/<aten op>`.  Then the
16-member heterogeneous step (`hetero_ensemble_step`, chip_smoke.py's
members: 4 each of I3D, TwoStream-I3D, C3D and R3D-18, bf16, on 0-255 rgb,
the flow computed in the step as the JAX bench does) at B=16, with its
device time also summed by family (the outermost of the ranges `flow`,
`member` (I3D), `two_stream`, `c3d`, `r3d` above each kernel; `shared
inputs` for the stagings and casts, `fusion`).  Then the resident TwoStream
pipeline (`twostream_ensemble_step`, chip_smoke.py's 4 TwoStream members
on its moving-texture I420 rows) at B=16, and turbo Farnebäck alone on the
JAX bench's 76 pairs of 224², its time split into the solver's parts
(`pyramid`, `poly_exp`, `warp`, `update`, `upsample`).  Last, the int8
main path (`int8`: chip_smoke.py's phase 20, 4 static-int8 I3D members
calibrated by `calibrate_members` on 2 batches of main-path clips) at B=16
and B=48, its int8 convs and quantize passes charged to
`member/csec::int8_conv3d` and `member/csec::quantize_int8`.
`--paths int8` (a comma list of main, member, train, zoo, hetero,
twostream, flow, int8) profiles only those.

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
BATCHES, TRAIN_BATCHES, STEPS = (16, 48), (16, 64), 3
TRAIN_ZOO = (("C3D", 32, "train_c3d"), ("TWOSTREAM_I3D", 16, "train_twostream"), ("R3D_18", 32, "train_r3d18"))
FAMILY_LABELS = {"flow": "flow", "member": "I3D", "two_stream": "TWOSTREAM_I3D", "c3d": "C3D", "r3d": "R3D_18"}
OWN_KERNELS = {"maxpool3x3x3_kernel": "max_pool_3x3x3_same", "salt_pepper_kernel": "salt_pepper",
               "stem_bf16_kernel": "stem", "maxpool3_bwd_": "max_pool_3x3x3_same_backward",
               "int8_conv3d_": "int8_conv3d", "int8_dequant_kernel": "int8_conv3d",
               "quantize_int8_": "quantize_int8"}
PATHS = ("main", "member", "train", "zoo", "hetero", "twostream", "flow", "int8")


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
    import crowded_scenes_ensemble_classification_tpu_torch.flow.farneback as farneback_mod
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
        wrap(pipeline_mod, "clip_flow", "flow"),
        wrap(farneback_mod, "build_pyramid", "pyramid"),
        wrap(farneback_mod, "_poly_exp_packed", "poly_exp"),
        wrap(farneback_mod, "warp_image_separable", "warp"),
        wrap(farneback_mod, "warp_image_mxu", "warp"),
        wrap(farneback_mod, "_displacement_update_packed", "update"),
        wrap(farneback_mod, "upsample_flow", "upsample"),
        wrap(engine_mod, "_gather", "gather"),
        wrap(engine_mod, "_preprocess", "preprocess"),
        wrap(engine_mod, "gray_pair_flow", "flow"),
        wrap(state_mod.KerasSGD, "step", "optimizer"),
        wrap(state_mod.KerasAdam, "step", "optimizer"),
    }


def stage_of(event, labels) -> str:
    """Innermost label range above `event`, joined with the outermost aten
    or kernel custom op (`csec::`) between the two."""
    outer_op = None
    while event is not None:
        if event.name in labels:
            return f"{event.name}/{outer_op}" if outer_op else event.name
        if event.name.startswith(("aten::", "csec::")):
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


def family_ms(events, labels, steps: int) -> dict:
    """Device ms per step summed by the outermost family range above each
    kernel (FAMILY_LABELS); what no family range holds (stagings, casts,
    fusion) is `shared inputs and fusion`, and kernels the profiler linked
    to no op are `unlinked`."""
    from torch.autograd import DeviceType

    out = collections.defaultdict(float)
    device = sum(e.time_range.end - e.time_range.start for e in events
                 if e.device_type == DeviceType.CUDA and e.name not in labels)
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        family, parent = "shared inputs and fusion", e
        while parent is not None:
            family = FAMILY_LABELS.get(parent.name, family)
            parent = parent.cpu_parent
        out[family] += sum(k.duration for k in e.kernels) / 1e3 / steps
    out["unlinked"] = device / 1e3 / steps - sum(out.values())
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def profile_run(path: str, batch: int, steps: int, step, labels, torch, families: bool = False) -> dict:
    """Warm up, time `steps` calls of step(i) unprofiled, then `steps` more
    under the profiler → busy ms, ms by stage and aten op (and by family)."""
    counter = iter(range(10**6))

    def run() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step(next(counter))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run()  # warm-up: cuDNN plans, allocator
    plain_s = run()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        wall_s = run()
    out = {"path": path, "batch": batch, "steps": steps,
           "wall_ms_per_step_unprofiled": plain_s * 1e3 / steps,
           "clips_per_s_unprofiled": steps * batch / plain_s}
    events = prof.events()
    out.update(breakdown(events, labels, wall_s, steps))
    out["busy_share_of_unprofiled_wall"] = out["busy_ms_per_step"] / out["wall_ms_per_step_unprofiled"]
    if families:
        out["families_ms_per_step"] = family_ms(events, labels, steps)
    return out


def profile_hetero(batch: int, steps: int, labels, torch, np) -> dict:
    """The 16-member heterogeneous step at `batch`, chip_smoke.py's members
    and rgb, the flow computed in the step; busy ms, ms by stage and aten
    op, ms by family (the flow as a family of its own)."""
    import chip_smoke
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.pipeline import hetero_ensemble_step

    dev = torch.device("cuda")
    families = chip_smoke.hetero_families(torch)
    rgb = chip_smoke.seeded_clips(torch, dev, (batch, FRAMES, SIZE, SIZE, 3), 500 + batch)
    out = profile_run("hetero", batch, steps, lambda i: hetero_ensemble_step(families, rgb), labels, torch,
                      families=True)
    del families, rgb
    torch.cuda.empty_cache()
    return out


def profile_twostream(batch: int, steps: int, labels, torch, np) -> dict:
    """The resident TwoStream pipeline at `batch`: chip_smoke.py's members
    and I420 rows."""
    import chip_smoke
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.pipeline import twostream_ensemble_step

    members = [b.module for b in chip_smoke.seeded_members(torch, "TWOSTREAM_I3D", MEMBERS, 1500,
                                                           stem_prestaged=True)]
    resident = torch.from_numpy(chip_smoke.moving_texture_rows(np, 3 * batch)).cuda()
    gen = torch.Generator().manual_seed(4)
    out = profile_run("twostream", batch, steps, lambda i: twostream_ensemble_step(
        members, resident, i, gen, batch_size=batch, frames=FRAMES, staging=STAGING, out_hw=(SIZE, SIZE)),
        labels, torch, families=True)
    del members, resident
    torch.cuda.empty_cache()
    return out


def profile_flow(steps: int, labels, torch, np) -> dict:
    """Turbo Farnebäck alone on the JAX bench's 76 pairs of 224² (one batch,
    as bench.py:343-382 times it): busy ms and idle share of a call."""
    import chip_smoke
    from crowded_scenes_ensemble_classification_tpu_torch.flow.farneback import TURBO_PARAMS, farneback_flow_batch

    prevs, currs = chip_smoke.bench_flow_pairs(np, chip_smoke.FLOW_PAIRS, SIZE)
    p, c = torch.from_numpy(prevs).cuda(), torch.from_numpy(currs).cuda()
    with torch.inference_mode():
        out = profile_run("flow_turbo_76_pairs", chip_smoke.FLOW_PAIRS, steps,
                          lambda i: farneback_flow_batch(p, c, **TURBO_PARAMS), labels, torch)
    out["fields_per_s_unprofiled"] = out.pop("clips_per_s_unprofiled")
    return out


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


def profile_int8(batches, steps: int, labels, torch, np) -> list:
    """The int8 main path at each batch: chip_smoke.py's static members on
    its resident rows, one record a batch."""
    import chip_smoke
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.members import calibrate_members
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.pipeline import resident_ensemble_step

    dev = torch.device("cuda")
    ibytes = FRAMES * STAGING * STAGING * 3 // 2
    rows = np.random.default_rng(23).integers(0, 256, (steps * max(batches), ibytes), dtype=np.uint8)
    resident = torch.from_numpy(rows).to(dev)
    members = [b.module for b in chip_smoke.seeded_members(torch, "I3D", MEMBERS, 1700, quant="calib",
                                                           stem_prestaged=True)]
    calibrate_members(members, chip_smoke.int8_main_clips(torch, resident, 24, 2), (SIZE, SIZE), num_batches=2)
    out = []
    for batch in batches:
        gen = torch.Generator().manual_seed(4)
        out.append(profile_run("int8", batch, steps, lambda i: resident_ensemble_step(
            members, resident, i, gen, batch_size=batch, frames=FRAMES, staging=STAGING, out_hw=(SIZE, SIZE)),
            labels, torch))
    del members, resident
    torch.cuda.empty_cache()
    return out


def profile_member_paths(batch: int, steps: int, torch, np) -> list:
    """chip_smoke.py's per-member paths at `batch`, one record each.  Runs
    before `label_stages`, whose ranges `torch.export` would trace into the
    served graph, so its device time is charged to aten ops only."""
    import tempfile

    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.members import make_member_forward
    from crowded_scenes_ensemble_classification_tpu_torch.models import build_model
    from crowded_scenes_ensemble_classification_tpu_torch.serving import (
        export_ensemble,
        load_serving_artifact,
        save_serving_artifact,
        serving_batch_example,
    )

    gen = torch.Generator().manual_seed(6)
    bundles = [build_model("I3D", dtype=torch.bfloat16, generator=gen, stem_impl="pallas")
               for _ in range(MEMBERS)]
    twins = [build_model("I3D", dtype=torch.bfloat16, stem_prestaged=True) for _ in bundles]
    for twin, b in zip(twins, bundles):
        twin.module.load_state_dict(b.module.state_dict())
    clips = np.random.default_rng(7).integers(0, 256, (steps, batch, FRAMES, SIZE, SIZE, 3), dtype=np.uint8)
    batches = [{"rgb": torch.from_numpy(c).cuda()} for c in clips]
    scale = 1 / 255.0
    program = export_ensemble(bundles, serving_batch_example(bundles[0], batch), input_scale=scale)
    with tempfile.TemporaryDirectory() as tmp:
        path = save_serving_artifact(os.path.join(tmp, "ensemble.zip"), program, {})
        serve, _ = load_serving_artifact(path)
    forwards = {
        "member_unshared_kernel_stem": make_member_forward(
            [b.module for b in bundles], (SIZE, SIZE), input_scale=scale),
        "member_shared_cudnn_stem": make_member_forward(
            [t.module for t in twins], (SIZE, SIZE), share_stem_staging=True, input_scale=scale),
        "served_unshared_kernel_stem": serve,
    }
    out = []
    for name, fn in forwards.items():
        def run() -> float:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in batches:
                fn(b)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        run()  # warm-up
        plain_s = run()
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            wall_s = run()
        r = {"path": name, "batch": batch, "steps": steps,
             "wall_ms_per_step_unprofiled": plain_s * 1e3 / steps,
             "clips_per_s_unprofiled": steps * batch / plain_s}
        r.update(breakdown(prof.events(), set(), wall_s, steps))
        r["busy_share_of_unprofiled_wall"] = r["busy_ms_per_step"] / r["wall_ms_per_step_unprofiled"]
        out.append(r)
    del bundles, twins, batches, program, serve, forwards
    torch.cuda.empty_cache()
    return out


def profile_train(model_type: str, batch: int, steps: int, labels, torch, np, path: str = "train_resident") -> dict:
    """The resident train step of `model_type` at `batch` (chip_smoke.py's
    `zoo_resident` data: staging the model size + 32, TwoStream's gray
    pairs with turbo Farnebäck in the step; the family's optimizer and l2):
    2 warm-up steps, `steps` unprofiled, `steps` profiled."""
    import chip_smoke
    from crowded_scenes_ensemble_classification_tpu_torch.flow.farneback import flow_schedule_params
    from crowded_scenes_ensemble_classification_tpu_torch.models import build_model
    from crowded_scenes_ensemble_classification_tpu_torch.train import (
        TrainState,
        make_resident_train_step,
        train_policy,
    )

    bundle = build_model(model_type, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(13),
                         trainable=True)
    data = chip_smoke.zoo_resident(np, np.random.default_rng(9), bundle, batch, batch)
    tx, l2 = train_policy(model_type)
    fp = flow_schedule_params("turbo") if bundle.two_stream else None
    step = make_resident_train_step(bundle, tx, (bundle.clip.height, bundle.clip.width), augment=True, l2_weight=l2,
                                    input_scale=1 / 255.0, flow_params=fp)
    state = TrainState.create(bundle.module, tx)
    cw = torch.ones(CLASSES, device="cuda")
    epoch = iter(range(10**6))

    def run(n: int) -> float:
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = step(state, next(data.batches(next(epoch))), cw)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(2)  # warm-up: kernel build, cuDNN plans, allocator
    plain_s = run(steps)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        wall_s = run(steps)
    out = {"path": path, "batch": batch, "steps": steps,
           "wall_ms_per_step_unprofiled": plain_s * 1e3 / steps,
           "clips_per_s_unprofiled": steps * batch / plain_s}
    out.update(breakdown(prof.events(), labels, wall_s, steps))
    out["busy_share_of_unprofiled_wall"] = out["busy_ms_per_step"] / out["wall_ms_per_step_unprofiled"]
    del bundle, data, state, step
    torch.cuda.empty_cache()
    return out


def print_record(title: str, r: dict) -> None:
    rate = r.get("clips_per_s_unprofiled", r.get("fields_per_s_unprofiled"))
    print(f"{title}: {rate:.2f} {'fields' if 'fields_per_s_unprofiled' in r else 'clips'}/s unprofiled "
          f"({r['wall_ms_per_step_unprofiled']:.3f} ms/step); profiled wall {r['wall_ms_per_step']:.3f} "
          f"ms/step, device busy {r['busy_ms_per_step']:.3f} ms/step, idle share {r['idle_share']:.4f}")
    for name, s in r["stages"].items():
        if s["share_of_busy"] >= 1e-3:
            print(f"  {name:50s} {s['ms_per_step']:9.3f} ms/step  {100 * s['share_of_busy']:6.2f} %")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/profile_step_torch.json")
    ap.add_argument("--paths", default=",".join(PATHS), help="comma list of " + ", ".join(PATHS))
    args = ap.parse_args()
    paths = set(args.paths.split(","))
    if not paths <= set(PATHS):
        ap.error(f"unknown paths {sorted(paths - set(PATHS))}")

    import numpy as np
    import torch

    from crowded_scenes_ensemble_classification_tpu_torch.utils.device import require_cuda

    smi = require_cuda()
    print(smi)
    member_records = profile_member_paths(BATCHES[0], STEPS, torch, np) if "member" in paths else []
    labels = label_stages(torch)
    results = []

    def record(title: str, r: dict) -> dict:
        r["device"] = smi
        results.append(r)
        print_record(title, r)
        return r

    for batch in BATCHES if "main" in paths else ():
        record(f"B={batch}", profile_batch(batch, STEPS, labels, torch, np))
    for r in member_records:
        record(f"{r['path']} B={r['batch']}", r)
    for batch in TRAIN_BATCHES if "train" in paths else ():
        record(f"train B={batch}", profile_train("I3D", batch, STEPS, labels, torch, np))
    for model_type, batch, path in TRAIN_ZOO if "zoo" in paths else ():
        record(f"{path} B={batch}", profile_train(model_type, batch, STEPS, labels, torch, np, path))
    for profile in (p for name, p in (("hetero", profile_hetero), ("twostream", profile_twostream)) if name in paths):
        r = profile(BATCHES[0], STEPS, labels, torch, np)
        record(f"{r['path']} B={r['batch']}", r)
        print("  by family: " + ", ".join(f"{k} {v:.3f} ms" for k, v in r["families_ms_per_step"].items()))
    if "flow" in paths:
        r = profile_flow(STEPS, labels, torch, np)
        record(r["path"], r)
    for r in profile_int8(BATCHES, STEPS, labels, torch, np) if "int8" in paths else ():
        record(f"int8 B={r['batch']}", r)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

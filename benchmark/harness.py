"""One run of one benchmark cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (`benchmark/workloads/<cell>.json`) names its configuration
(`benchmark/configs/`), its traffic mix (`benchmark/traffic/`), its entry
(`benchmark/entries/<entry>.py`, the loop that drives one entry point of
the program) and the limits of its check; `BENCHMARK.json` names the
metrics it reports, each read by `benchmark/metrics/<metric>.py`.  All are
found by name, so a cell, a mix or a metric is added by adding files.

A run: set-up (the entry makes the weights and inputs from the seed,
builds the program's state, warms every shape it will use) → the measured
window of `--seconds` (under the profiler with `--trace 1`) → the peak
device memory → the program's state freed → the check against the plain
reference (TF32 off) → the metrics, the checks on standard error, and one
JSON line on standard output.  It measures only on a CUDA card; without
one, or with the JAX package or JAX loaded, it prints no result and exits
with a code other than 0.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import math
import os
import sys
import time
import types
from typing import Dict, List, Optional

from . import check, trace

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "crowded_scenes_ensemble_classification_tpu")


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(BENCH_DIR, kind, name + ".json")) as f:
        return json.load(f)


def load_module(kind: str, name: str) -> types.ModuleType:
    """benchmark/<kind>/<name>.py, imported as a module of this package."""
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_names(cell: str, traced: bool) -> List[str]:
    """The metrics BENCHMARK.json has this cell report: its end-to-end ones
    untraced, its per-layer ones traced."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    e2e = [m["name"] for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    return [m["name"] for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def forbidden_loaded() -> List[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN_MODULES))


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    program's kernels build into build/kernels there by themselves)."""
    build = os.path.join(ROOT, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")


def measure(cell: dict, config: dict, traffic_mix: dict, seed: int, seconds: float, traced: bool,
            device, metrics: List[str], t_start: float, control: Optional[str] = None) -> Dict:
    """One run of a cell on `device` → the result's fields (see the module
    docstring).  `control` ('fp8' or 'int4') puts the reference, computed
    in that precision, in the program's place for the check."""
    import torch

    ctx = types.SimpleNamespace(seed=seed, device=device, cell=cell, config=config, traffic=traffic_mix,
                                control=control)
    labels = trace.label_stages(torch) if traced else set()
    entry = load_module("entries", cell["entry"]).Entry(ctx)
    setup_s = time.perf_counter() - t_start
    prof_box: Dict = {}

    @contextlib.contextmanager
    def tracing():
        if not traced:
            yield
            return
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            yield
        prof_box["prof"] = prof

    record = entry.window(seconds, tracing)
    summary = trace.summarize(prof_box.pop("prof"), labels, record["elapsed_s"]) if traced else None
    cuda = device.type == "cuda"
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    entry.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = entry.check(record)
    checks = check.verdict(result["readings"], cell["limits"])
    run = types.SimpleNamespace(record=record, summary=summary, config=config, traffic=traffic_mix, cell=cell,
                                setup_s=setup_s)
    values = {}
    for name in metrics:
        value = load_module("metrics", name).read(run)
        if value is not None:
            values[name] = {"value": float(value), "unit": load_module("metrics", name).UNIT}
    per_step = record.get("clips_per_batch") or record.get("clips_per_step")
    answered = len(record["batches"]) if "batches" in record else record["steps"]
    failed = result["failed"] * (1 if "batches" in record else per_step)
    out = {"correct": bool(all(c["ok"] for c in checks) and failed == 0),
           "attempted": answered * per_step, "failed": failed, "metrics": values,
           "device": {"platform": "gpu" if cuda else device.type,
                      "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                      "count": 1, "memory_peak_bytes": peak}}
    if summary is not None:
        out["device"].update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        out["breakdown"] = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    out["readings"] = result["readings"]
    out["checks"] = {c["name"]: {"value": c["value"] if math.isfinite(c["value"]) else None, "limit": c["limit"]}
                     for c in checks}
    return out


def parse(argv: List[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="One run of one benchmark cell on one CUDA card.")
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json (benchmark/workloads/<name>.json)")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0, help="1: per-layer metrics from a profile")
    ap.add_argument("--control", choices=("fp8", "int4"), default=None,
                    help="put the reference, in this precision, in the program's place for the check")
    return ap.parse_args(argv)


def main(argv: List[str], t_start: float) -> int:
    args = parse(argv)
    cell = load_json("workloads", args.workload)
    set_cache_dirs()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload}: needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    out = measure(cell, load_json("configs", cell["config"]), load_json("traffic", cell["traffic"]),
                  args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                  metric_names(args.workload, bool(args.trace)), t_start, args.control)
    out.pop("readings")
    found = forbidden_loaded()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0

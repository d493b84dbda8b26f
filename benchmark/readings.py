"""The readings that a cell's limits are set from, on one card, in one
process: the program's check on many seeds, and the control's (the
reference in a lower precision put in the program's place) on some.

    python3 benchmark/readings.py --workload <cell> --seeds 12 --control fp8 --control-seeds 3 --seconds 3

Each run is a whole run of the cell (set-up, a short window at the cell's
own load, the check); one JSON line a run on standard output: the seed,
whether it is the program or the control, and the numbers compared.  The
benchmark's own runs never run the control.  `--base-seed` picks the first
seed; seeds follow it."""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", choices=("bf16", "fp8", "int4"), default=None)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--base-seed", type=int, default=2**31 + 1000)
    args = ap.parse_args()
    harness.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    cell = harness.load_json("workloads", args.workload)
    config = harness.load_json("configs", cell["config"])
    mix = harness.load_json("traffic", cell["traffic"])
    runs = [(args.base_seed + i, None) for i in range(args.seeds)]
    if args.control:
        runs += [(args.base_seed + i, args.control) for i in range(args.control_seeds)]
    for seed, control in runs:
        t0 = time.perf_counter()
        out = harness.measure(cell, config, mix, seed, args.seconds, False, torch.device("cuda", 0),
                              [], t0, control)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": control, "correct": out["correct"],
                          "failed": out["failed"], "attempted": out["attempted"],
                          "readings": out["readings"],
                          "seconds": time.perf_counter() - t0}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

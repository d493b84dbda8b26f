"""Measure a cell's run-to-run spread, the way its bounds are set: one
process a run, as the check runs them.

    python3 benchmark/spread.py --workload <cell> --seconds 42 --runs 6 --sets 2 --traced 3 --base-seed <n>

First `--warm` runs (the first builds the kernels in a fresh checkout;
their set-up is reported apart), then `--sets` sets of `--runs` runs with
the same seeds in every set, then `--traced` runs with `--trace 1` on
other seeds.  Writes every result line to `--out` (JSON lines) and prints,
for each end-to-end metric, each set's median and spread (the distance
between the first and third quartiles of `statistics.quantiles(values,
n=4)`, as a share of the median) and the wider of the sets' spreads."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def run_once(workload: str, seed: int, seconds: float, trace: int) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(HERE, "run.py"), "--workload", workload, "--seed", str(seed),
                           "--seconds", str(seconds), "--trace", str(trace)],
                          capture_output=True, text=True, cwd=os.path.dirname(HERE))
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    return {"seed": seed, "trace": trace, "rc": proc.returncode, "wall_s": time.perf_counter() - t0,
            "result": result, "stderr_tail": proc.stderr[-1500:] if result is None else proc.stderr[-300:]}


def spread(values) -> float:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--warm", type=int, default=1)
    ap.add_argument("--traced", type=int, default=3)
    ap.add_argument("--base-seed", type=int, default=2**31 + 2000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out = open(args.out, "a") if args.out else None
    plan = [("warm", args.base_seed + 100 + i, 0) for i in range(args.warm)]
    plan += [(f"set{s}", args.base_seed + i, 0) for s in range(args.sets) for i in range(args.runs)]
    plan += [("traced", args.base_seed + 200 + i, 1) for i in range(args.traced)]
    results = []
    for group, seed, trace in plan:
        r = run_once(args.workload, seed, args.seconds, trace)
        r["group"], r["workload"] = group, args.workload
        results.append(r)
        if out:
            out.write(json.dumps(r) + "\n")
            out.flush()
        res = r["result"] or {}
        print(f"{group} seed={seed} rc={r['rc']} wall={r['wall_s']:.1f}s correct={res.get('correct')} "
              + " ".join(f"{k}={v['value']:.6g}" for k, v in res.get("metrics", {}).items())
              + ("" if res else " " + r["stderr_tail"][-600:].replace("\n", " | ")), flush=True)
    sets = [[r for r in results if r["group"] == f"set{s}" and r["result"]] for s in range(args.sets)]
    names = sorted({k for group in sets for r in group for k in r["result"]["metrics"]})
    for name in names:
        per_set = [[r["result"]["metrics"][name]["value"] for r in group if name in r["result"]["metrics"]]
                   for group in sets]
        stats = [(statistics.median(v), spread(v)) for v in per_set if len(v) >= 2]
        if stats:
            print(f"{name}: " + "; ".join(f"median {m:.6g} spread {100 * s:.3f}%" for m, s in stats)
                  + f"; widest {100 * max(s for _, s in stats):.3f}%"
                  + (f"; second median vs first {100 * (stats[1][0] / stats[0][0] - 1):+.3f}%" if len(stats) > 1
                     else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())

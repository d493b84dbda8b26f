"""The look behind the training cell's absence from BENCHMARK.json: on one
card, for a few seeds, the readings of `i3d_crowd11.train_b64`'s check for
four stand-ins in the program's place:

- `bf16_program`: the program as the configuration states it;
- `f32_program`: the program computing in float32, TF32 off (a second
  witness that sides with the reference when the program is sound);
- `ref_bf16`, `ref_fp8`: the reference with its conv operands rounded to
  bfloat16 or float8.

    python3 benchmark/train_witness.py [--seeds 3] [--base-seed <n>]

One JSON line a seed and stand-in: the check's numbers (each step's loss,
the first gradient and the change by the worst and the median leaf)."""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--base-seed", type=int, default=3000000500)
    args = ap.parse_args()
    harness.set_cache_dirs()
    import torch

    from benchmark.entries import resident_train

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    cell = harness.load_json("workloads", "i3d_crowd11.train_b64")
    config = harness.load_json("configs", cell["config"])
    mix = harness.load_json("traffic", cell["traffic"])
    for seed in range(args.base_seed, args.base_seed + args.seeds):
        for variant in ("bf16_program", "f32_program", "ref_bf16", "ref_fp8"):
            cfg = copy.deepcopy(config)
            torch.backends.cudnn.allow_tf32 = variant != "f32_program"
            if variant == "f32_program":
                cfg["train"]["compute_dtype"] = "float32"
            control = {"ref_bf16": "bf16", "ref_fp8": "fp8"}.get(variant)
            ctx = types.SimpleNamespace(seed=seed, device=torch.device("cuda", 0), cell=cell, config=cfg,
                                        traffic=mix, control=control)
            t0 = time.perf_counter()
            entry = resident_train.Entry(ctx)
            entry.release()
            torch.backends.cudnn.allow_tf32 = False
            readings = entry.check({"losses": []})["readings"]
            print(json.dumps({"seed": seed, "variant": variant, **readings, "s": time.perf_counter() - t0}),
                  flush=True)
            del entry
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

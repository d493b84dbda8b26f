#!/usr/bin/env python3
"""Time the 3³/1 max-pool kernel (or its gradient) under other tilings than its tiler's, on one CUDA card.

    python3 tools/sweep_maxpool_tiling_torch.py [--backward] [--out build/sweep_maxpool_tiling_torch.json]

For each distinct Mixed-block shape of chip_smoke.py (B=16, bf16) it calls
the kernel's C launcher directly with every H-tile height `ht` (1-8) and
C-block width `cv` (1, 2, 4 or 8 units of 16 bytes) that the kernel takes
with all of W in a block, checks each result equal to the plain version,
and times it cold
(chip_smoke.py's `cuda_ms_cold`: a rotation of inputs over twice the L2,
the device queued ahead of the host).  Prints, per shape, the tiler's own
choice (`max_pool_tiling`) and the five fastest, in µs, and writes every
reading as JSON to --out.

With `--backward` it sweeps the gradient kernel instead: every H-tile
height `ht` (1-8) and C-block width `cv` (1, 2, 4 or 8 units) that
`max_pool_backward_tile` accepts, each result `torch.equal` to the
tiler's (the sum's order does not depend on the tile), timed cold on
(x, dy) pairs.  Needs one card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="build/sweep_maxpool_tiling_torch.json")
    parser.add_argument("--backward", action="store_true", help="sweep the gradient kernel")
    args = parser.parse_args()
    if args.backward:
        return sweep_backward(args.out)

    import torch

    from chip_smoke import POOL_SHAPES, check, cold_inputs, cuda_ms_cold
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels._build import check_launch, load_library
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import (
        max_pool_3x3x3_reference,
        max_pool_tiling,
    )
    from crowded_scenes_ensemble_classification_tpu_torch.utils.device import require_cuda

    print(require_cuda())
    lib = load_library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = []
    for shape in dict.fromkeys(POOL_SHAPES):  # distinct, in order
        b, t, h, w, c = shape
        x = torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
        xs, ref = cold_inputs(x), max_pool_3x3x3_reference(x)
        chosen = max_pool_tiling(shape, 2, sms=sms)

        def launch(x, ht, cv):
            y = torch.empty_like(x)
            err = lib.maxpool3x3x3_same(x.data_ptr(), y.data_ptr(), b, t, h, w, c, 1, 1, ht, w, cv,
                                        torch.cuda.current_stream().cuda_stream)
            check_launch("maxpool3x3x3_same", err)
            return y

        rows = []
        for cv in (8, 4, 2, 1):
            if w * cv > 256:
                continue
            for ht in range(min(h, 8), 0, -1):
                check(torch.equal(launch(x, ht, cv), ref), f"kernel != plain at {shape}, ht {ht}, cv {cv}")
                us = 1e3 * cuda_ms_cold(lambda x: launch(x, ht, cv), xs)
                rows.append({"shape": shape, "ht": ht, "cv": cv, "grid": b * -(-h // ht) * -(-c // (8 * cv)),
                             "us": us, "chosen": (ht, cv) == (chosen.ht, chosen.cv)})
        records += rows
        name = lambda r: f"ht {r['ht']} cv {r['cv']} (grid {r['grid']}) {r['us']:.1f}"  # noqa: E731
        mine = next(r for r in rows if r["chosen"])
        print(f"{shape}: cold µs, the tiler's {name(mine)}; fastest: "
              + "; ".join(name(r) for r in sorted(rows, key=lambda r: r["us"])[:5]))
        del xs
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0), "records": records}, f, indent=1)
    return 0


def sweep_backward(out: str) -> int:
    import torch

    from chip_smoke import POOL_SHAPES, check, cold_inputs, cuda_ms_cold
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels._build import check_launch, load_library
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import (
        max_pool_3x3x3_same_backward,
        max_pool_backward_tile,
        max_pool_backward_tiling,
    )
    from crowded_scenes_ensemble_classification_tpu_torch.utils.device import require_cuda

    print(require_cuda())
    lib = load_library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = []
    for shape in dict.fromkeys(POOL_SHAPES):  # distinct, in order
        x, dy = (torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(2))
        pairs, ref = list(zip(cold_inputs(x), cold_inputs(dy))), max_pool_3x3x3_same_backward(x, dy)
        chosen = max_pool_backward_tiling(shape, 2, sms=sms)

        def launch(p, t):
            dx = torch.empty_like(p[0])
            err = lib.maxpool3x3x3_same_backward(p[0].data_ptr(), p[1].data_ptr(), dx.data_ptr(), *shape, 1, 1,
                                                 t.ht, t.wt, t.cv, t.groups, torch.cuda.current_stream().cuda_stream)
            check_launch("maxpool3x3x3_same_backward", err)
            return dx

        rows = []
        for cv in (8, 4, 2, 1):
            for ht in range(min(shape[2], 8), 0, -1):
                try:
                    t = max_pool_backward_tile(shape, 2, True, cv, ht)
                except ValueError:
                    continue
                check(torch.equal(launch((x, dy), t), ref), f"gradient != the tiler's at {shape}, ht {ht}, cv {cv}")
                us = 1e3 * cuda_ms_cold(lambda p: launch(p, t), pairs)
                rows.append({"shape": shape, "ht": ht, "cv": cv, "grid": t.grid, "threads": t.threads,
                             "smem": t.smem, "us": us, "chosen": (ht, cv) == (chosen.ht, chosen.cv)})
        records += rows
        name = lambda r: f"ht {r['ht']} cv {r['cv']} (grid {r['grid']}, {r['smem']} B) {r['us']:.1f}"  # noqa: E731
        mine = next(r for r in rows if r["chosen"])
        print(f"{shape}: cold µs, the tiler's {name(mine)}; fastest: "
              + "; ".join(name(r) for r in sorted(rows, key=lambda r: r["us"])[:5]))
        del pairs
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0), "records": records}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

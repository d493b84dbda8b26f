#!/usr/bin/env python3
"""Time the 3³/1 max-pool gradient kernel at the 9 Mixed-block shapes of one I3D member, on one CUDA card.

    python3 tools/time_maxpool_bwd_torch.py [--package-root DIR]

Builds the kernels, holds the gradient kernel to its plain version at
chip_smoke.py's Mixed-block shapes (B=16, bf16, tie-heavy x and dy in
multiples of 1/8: within one bf16 rounding of the f32 plain result), and
times it by chip_smoke.py's `time_maxpool_backward`: cold (a rotation of
inputs over twice the L2, the device queued ahead of the host) and warm, a
line per shape with its tile, GB/s and share of the bound, beside the plain
version and the library route.  The last line is a JSON record of the sums.

`--package-root` imports the port from another checkout (an unpacked
parent commit, say) with this checkout's measurement code, so that two
versions of the kernel are timed by one script, in turns, in one call:

    for r in build/parent . . build/parent; do python3 tools/time_maxpool_bwd_torch.py --package-root $r; done

Needs one card; imports no JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--package-root", default=ROOT)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.package_root))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels import maxpool
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels._build import build, load_library
    from crowded_scenes_ensemble_classification_tpu_torch.utils.device import require_cuda

    print(require_cuda())
    print(f"package from {os.path.abspath(args.package_root)}")
    lib, nvcc_s = build()
    load_library()
    print(f"kernels built: {lib.name} (nvcc {nvcc_s:.1f} s)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    for shape in smoke.POOL_SHAPES:
        x32 = smoke.tie_heavy(shape, torch.float32, gen, dev, torch)
        dy32 = torch.randint(-8, 8, shape, device=dev, generator=gen).float() / 8
        ref = maxpool.max_pool_3x3x3_backward_reference(x32, dy32)
        got = maxpool.max_pool_3x3x3_same_backward(x32.bfloat16(), dy32.bfloat16()).float()
        smoke.check(bool(((got - ref).abs() <= ref.abs() * 2.0**-8).all()), f"gradient != plain at {shape}")
    tile = None  # the tiler's tile, where the checkout has the one-pass kernel
    if not hasattr(maxpool, "max_pool_backward_tiling"):
        tile = lambda shape: "two passes, argmax codes through global memory"  # noqa: E731
    tot = smoke.time_maxpool_backward(torch, dev, gen, tile=tile)
    bound_ms = tot["bytes"] / smoke.HBM_BYTES * 1e3
    print(f"the kernel == its plain version at all {len(smoke.POOL_SHAPES)} shapes; cold {tot['cold']:.4f} ms, "
          f"{bound_ms / tot['cold']:.1%} of the {bound_ms:.4f} ms bound; warm {tot['warm']:.4f} ms")
    print(json.dumps({"package_root": os.path.abspath(args.package_root), "cold_ms": tot["cold"],
                      "warm_ms": tot["warm"], "plain_ms": tot["plain"], "bound_ms": bound_ms,
                      "library_ms": tot["lib_fwd"] + tot["lib_bwd"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the int8 conv kernel at the 57 convs of one static I3D member, on one CUDA card.

    python3 tools/time_int8_conv_torch.py [--batch 16] [--package-root DIR]

Builds the kernels, one full-width static-int8 I3D member (prestaged
stem, bf16 compute, f32 weights drawn on the card from a seed, BN spread,
calibrated by `calibrate_members` on one batch of seeded 0-255 clips), and
records its int8 conv calls at the batch size.  Each is held equal to the
plain version (`torch.equal`) and timed by chip_smoke.py's
`time_int8_convs`: warm and cold, its route and tile, cuDNN's bf16 conv of
the same shape and, for the 1³ convs, `torch._int_mm`; then the sums by
kind (stem, 3x3x3, 1x1x1).  The last line is a JSON record of the sums.

`--package-root` imports the port from another checkout (an unpacked
parent commit, say) with this checkout's measurement code, so that two
versions of the kernel are timed by one script, in turns, in one call:

    python3 tools/time_int8_conv_torch.py --package-root build/parent

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
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--package-root", default=ROOT)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.package_root))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.members import calibrate_members
    from crowded_scenes_ensemble_classification_tpu_torch.models.common import s2d_stem_stage
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels import int8_conv as ic
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels._build import build, load_library
    from crowded_scenes_ensemble_classification_tpu_torch.utils.device import require_cuda

    print(require_cuda())
    print(f"package from {os.path.abspath(args.package_root)}")
    torch.backends.cudnn.allow_tf32 = False
    lib, nvcc_s = build()
    load_library()
    print(f"kernels built: {lib.name} (nvcc {nvcc_s:.1f} s)")
    if not hasattr(ic, "int8_conv_route"):  # a checkout from before the wgmma design
        ic.int8_conv_route = lambda *a: {"tile": "128x64 mma.sync", "splits": 1, "a_copy": "registers"}

    dev = torch.device("cuda")
    (bundle,) = smoke.seeded_members(torch, "I3D", 1, 1700, quant="calib", stem_prestaged=True)
    size = (smoke.SIZE, smoke.SIZE)
    clips = smoke.seeded_clips(torch, dev, (args.batch, smoke.FRAMES, *size, 3), 24)
    (member,) = calibrate_members([bundle.module], [{"rgb": clips}], size, num_batches=1)
    xs = s2d_stem_stage(clips.to(torch.bfloat16))
    with torch.inference_mode():
        convs, quants = smoke.captured_int8_calls(lambda: member(xs))
        tot = smoke.time_int8_convs(torch, convs, quants)
    print(f"the kernel == its plain version at all {len(convs)} convs at B={args.batch}")
    print(json.dumps({"package_root": os.path.abspath(args.package_root), "batch": args.batch,
                      "cold_ms": tot["cold"], "warm_ms": tot["warm"], "bf16_cudnn_ms": tot["bf16"],
                      "cold_ms_by_kind": {k: v["cold"] for k, v in sorted(tot["by_kind"].items())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

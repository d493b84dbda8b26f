#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1):

1. require a CUDA card; print its `nvidia-smi` name and power limit;
2. build the hand-written kernels from `csrc/` (timed);
3. max-pool kernel == its plain version (`torch.equal`) at every shape the
   main path gives it, bf16 and f32, plus T=1, C=3 and C=130; timed;
4. salt/pepper kernel: gates off is identity, only gated clips change and
   only to 0/255, a length not divisible by 4 works, density in
   (0.005, 0.016), and kernel == plain version on the same Philox seed; timed;
5. one port I3D at a small input on the card (kernels, f32, TF32 off)
   against the same model on the CPU (plain versions);
6. the main path: 4 full-width random-init I3D members (11 classes, bf16),
   3 `resident_ensemble_step`s on synthetic I420 rows (20 frames, 256²
   staging → 224², B=16): launch counts, finite probabilities summing to 1;
   then noise gates off, through the kernels and through the plain versions
   on the card: fused argmax equal, max |Δprob| ≤ 1e-2.

The line before last is the kernels' JSON record; the last line is
`{"ok": true, "device": {...}}`.  Needs one card and no network.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
import time
from unittest import mock

from crowded_scenes_ensemble_classification_tpu_torch.core.config import CLIP_SPECS

PORT = "crowded_scenes_ensemble_classification_tpu_torch"
FRAMES, SIZE = CLIP_SPECS["I3D"].frames, CLIP_SPECS["I3D"].height  # 20, 224
STAGING, BATCH, MEMBERS, STEPS, CLASSES = 256, 16, 4, 3, 11  # JAX bench.py:81 staging


def _half(n: int) -> int:
    return math.ceil(n / 2)


# (B, T, H, W, C) of the 3³/1 pool branch in the 9 Mixed blocks: Mixed_3*
# after the stem and two (1,3,3)/(1,2,2) pools, Mixed_4* and Mixed_5* after
# one more stride-2 pool each ((10,28,28), (5,14,14), (3,7,7) at 20×224²).
_T3, _S3 = _half(FRAMES), SIZE // 8
POOL_SHAPES = (
    [(BATCH, _T3, _S3, _S3, c) for c in (192, 256)]
    + [(BATCH, _half(_T3), _half(_S3), _half(_S3), c) for c in (480, 512, 512, 512, 528)]
    + [(BATCH, _half(_half(_T3)), _half(_half(_S3)), _half(_half(_S3)), c) for c in (832, 832)]
)
ODD_POOL_SHAPES = [(2, 1, 5, 5, 64), (2, 3, 5, 7, 3), (2, 3, 5, 7, 130)]
NOISE_SHAPE = (BATCH, FRAMES, SIZE, SIZE, 3)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call, by CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_maxpool(torch, dev) -> dict:
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import (
        max_pool_3x3x3_reference,
        max_pool_3x3x3_same,
    )

    gen = torch.Generator(device=dev).manual_seed(0)
    err = 0.0
    for shape in POOL_SHAPES + ODD_POOL_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(shape, device=dev, generator=gen).to(dtype)
            got, ref = max_pool_3x3x3_same(x), max_pool_3x3x3_reference(x)
            torch.cuda.synchronize()
            err = max(err, (got.float() - ref.float()).abs().max().item())
            check(torch.equal(got, ref), f"max-pool kernel != plain at {shape} {dtype}")
    ms = plain_ms = 0.0
    for shape in POOL_SHAPES:
        x = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
        k, p = cuda_ms(lambda: max_pool_3x3x3_same(x)), cuda_ms(lambda: max_pool_3x3x3_reference(x))
        mb = 2 * x.numel() * x.element_size() / 1e6
        print(f"maxpool bf16 {shape}: kernel {k:.4f} ms ({mb / k:.1f} GB/s of 1 read + 1 write), plain {p:.4f} ms")
        ms, plain_ms = ms + k, plain_ms + p
    print(f"maxpool: all {len(POOL_SHAPES + ODD_POOL_SHAPES)} shapes x 2 dtypes equal; "
          f"9 Mixed-block pools of one member at B={BATCH}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"name": "max_pool_3x3x3_same", "route": "cuda",
            "source": f"{PORT}/csrc/maxpool3x3x3.cu",
            "replaces": "crowded_scenes_ensemble_classification_tpu/ops/pallas/maxpool.py:51",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def check_noise(torch, dev) -> dict:
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.noise import (
        salt_pepper,
        salt_pepper_plain,
    )

    def gates(*bits):
        return torch.tensor(bits, dtype=torch.bool, device=dev)

    x = torch.randint(1, 255, NOISE_SHAPE, device=dev).float()
    off = torch.zeros(BATCH, dtype=torch.bool, device=dev)
    check(torch.equal(salt_pepper(x, 11, off, off, 100), x), "noise gates off is not identity")

    odd = torch.full((3, 5, 7, 7, 3), 128.0, device=dev)  # 735 elements per clip
    out = salt_pepper(odd, 12, gates(True, True, False), gates(True, False, False), 100)
    check(torch.equal(out, salt_pepper_plain(odd, 12, gates(True, True, False), gates(True, False, False), 100)),
          "noise kernel != plain at a length not divisible by 4")

    flat = torch.full((8, FRAMES, SIZE, SIZE, 3), 128.0, device=dev)
    salt, pepper = gates(*[True] * 4, *[False] * 4), gates(*[True, False] * 4)
    out = salt_pepper(flat, 2**40 + 13, salt, pepper, 100)
    changed = out != 128.0
    check(not changed[~(salt | pepper)].any(), "noise changed a clip with both gates off")
    check(set(torch.unique(out[changed]).tolist()) <= {0.0, 255.0}, "noise wrote a value other than 0/255")
    salt_density = (out[salt] == 255.0).float().mean().item()
    pepper_density = (out[pepper] == 0.0).float().mean().item()
    check(0.005 < salt_density < 0.016, f"salt density {salt_density}")
    check(0.005 < pepper_density < 0.016, f"pepper density {pepper_density}")
    check(not (out[~salt] == 255.0).any() and not (out[~pepper] == 0.0).any(), "noise hit an ungated clip")

    salt, pepper = torch.rand(BATCH, device=dev) < 0.75, torch.rand(BATCH, device=dev) < 0.75
    got = salt_pepper(x, 2**61 + 7, salt, pepper, 100)
    ref = salt_pepper_plain(x, 2**61 + 7, salt, pepper, 100)
    err = (got - ref).abs().max().item()
    check(torch.equal(got, ref), "noise kernel != plain on the same seed")
    ms = cuda_ms(lambda: salt_pepper(x, 5, salt, pepper, 100))
    plain_ms = cuda_ms(lambda: salt_pepper_plain(x, 5, salt, pepper, 100), iters=5)
    mb = 2 * x.numel() * 4 / 1e6
    print(f"noise: identity, gating, odd length, kernel == plain ok; density salt {salt_density:.5f} "
          f"pepper {pepper_density:.5f}; {NOISE_SHAPE} f32: kernel {ms:.4f} ms ({mb / ms:.1f} GB/s), "
          f"plain {plain_ms:.4f} ms")
    return {"name": "salt_pepper", "route": "cuda", "source": f"{PORT}/csrc/salt_pepper.cu",
            "replaces": "crowded_scenes_ensemble_classification_tpu/ops/pallas/noise.py:52",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def spread_batchnorm(model, gen) -> None:
    """Draw BN statistics away from (0, 1) so a small-input check sees
    O(1) logits rather than vanishing ones."""
    import torch

    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm3d):
            m.running_var.uniform_(0.3, 0.7, generator=gen)
            m.running_mean.normal_(0.0, 0.1, generator=gen)
            m.bias.data.normal_(0.0, 0.1, generator=gen)


def check_small_model(torch, dev) -> None:
    from crowded_scenes_ensemble_classification_tpu_torch.models.i3d import I3D

    gen = torch.Generator().manual_seed(1)
    cpu = I3D(CLASSES, frames=16, generator=gen).eval()
    spread_batchnorm(cpu, gen)
    x = torch.randn(2, 16, 32, 32, 3, generator=gen) * 50.0
    with torch.inference_mode():
        ref = cpu(x)
        got = cpu.to(dev)(x.to(dev)).cpu()
    err = (got - ref).abs().max().item()
    print(f"small I3D (2,16,32,32,3) f32: card (kernels) vs CPU (plain) max |dlogit| {err:.3g}, "
          f"max |logit| {ref.abs().max().item():.3g}")
    check(torch.allclose(got, ref, rtol=1e-4, atol=1e-4), "card I3D disagrees with CPU I3D")


def timed_steps(step, torch):
    """Run step(i) for i < STEPS → (outputs, clips/s), timed on the host
    clock between two device synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [step(i) for i in range(STEPS)]
    torch.cuda.synchronize()
    return outs, STEPS * BATCH / (time.perf_counter() - t0)


def main_path_steps(members, resident, seed, torch):
    """STEPS calls of the main path's entry point."""
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.pipeline import (
        resident_ensemble_step,
    )

    gen = torch.Generator().manual_seed(seed)
    return timed_steps(lambda i: resident_ensemble_step(
        members, resident, i, gen, batch_size=BATCH, frames=FRAMES, staging=STAGING,
        out_hw=(SIZE, SIZE),
    ), torch)


def quiet_steps(members, resident, seed, torch):
    """The same steps on the same rows with the salt and pepper gates off:
    the decisions are drawn as the entry point draws them, then the two
    noise gates are cleared (the noise kernel still runs, as a copy)."""
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.pipeline import (
        AUGMENT_P,
        ensemble_step_from_decisions,
    )
    from crowded_scenes_ensemble_classification_tpu_torch.ops.augment import draw_decisions

    gen = torch.Generator().manual_seed(seed)

    def step(i):
        d = draw_decisions(gen, BATCH, (STAGING, STAGING), AUGMENT_P)
        off = torch.zeros_like(d.salt)
        d = dataclasses.replace(d, salt=off, pepper=off)
        rows = resident[i * BATCH : (i + 1) * BATCH]
        return ensemble_step_from_decisions(members, rows, d, FRAMES, STAGING, (SIZE, SIZE))

    return timed_steps(step, torch)


def check_main_path(torch, np, dev, kernels) -> None:
    import crowded_scenes_ensemble_classification_tpu_torch.models.i3d as i3d_mod
    import crowded_scenes_ensemble_classification_tpu_torch.ops.augment as augment_mod
    from crowded_scenes_ensemble_classification_tpu_torch.models.common import cast_for_inference
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import (
        max_pool_3x3x3_reference,
        max_pool_3x3x3_same,
    )
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.noise import (
        salt_pepper,
        salt_pepper_plain,
    )

    gen = torch.Generator().manual_seed(2)
    members = [
        cast_for_inference(i3d_mod.I3D(CLASSES, frames=FRAMES, stem_prestaged=True, generator=gen).to(dev),
                           torch.bfloat16).eval()
        for _ in range(MEMBERS)
    ]
    ibytes = FRAMES * STAGING * STAGING * 3 // 2
    rows = np.random.default_rng(3).integers(0, 256, (STEPS * BATCH, ibytes), dtype=np.uint8)
    resident = torch.from_numpy(rows).to(dev)

    main_path_steps(members, resident, 99, torch)  # warm-up: cuDNN plans, allocator
    max_pool_3x3x3_same.launches = salt_pepper.launches = 0
    outs, cps = main_path_steps(members, resident, 4, torch)
    launches = {"max_pool_3x3x3_same": max_pool_3x3x3_same.launches, "salt_pepper": salt_pepper.launches}
    print(f"main path: {STEPS} steps, {MEMBERS} members, B={BATCH}, bf16: {cps:.2f} clips/s; launches {launches}")
    check(launches["max_pool_3x3x3_same"] == 9 * MEMBERS * STEPS, "max-pool launch count")
    check(launches["salt_pepper"] == STEPS, "noise launch count")
    for probs, fused in outs:
        check(probs.shape == (MEMBERS, BATCH, CLASSES) and fused.shape == (BATCH,), "output shapes")
        check(bool(torch.isfinite(probs).all()), "non-finite probabilities")
        check(bool(((probs.sum(-1) - 1.0).abs() <= 1e-2).all()), "probabilities do not sum to 1")
    for k in kernels:
        k["launches"] = launches[k["name"]]

    quiet_kernel, cps_kernel = quiet_steps(members, resident, 5, torch)
    with mock.patch.object(i3d_mod, "max_pool_3x3x3_same", max_pool_3x3x3_reference), \
            mock.patch.object(augment_mod, "salt_pepper", salt_pepper_plain):
        before = (max_pool_3x3x3_same.launches, salt_pepper.launches)
        quiet_plain, cps_plain = quiet_steps(members, resident, 5, torch)
        check(before == (max_pool_3x3x3_same.launches, salt_pepper.launches), "plain run launched a kernel")
    dprob = max((a[0] - b[0]).abs().max().item() for a, b in zip(quiet_kernel, quiet_plain))
    same_argmax = all(torch.equal(a[1], b[1]) for a, b in zip(quiet_kernel, quiet_plain))
    print(f"noise gates off: kernels {cps_kernel:.2f} clips/s, plain versions {cps_plain:.2f} clips/s; "
          f"max |dprob| {dprob:.3g}; fused argmax equal: {same_argmax}")
    check(same_argmax, "fused argmax differs between kernel and plain runs")
    check(dprob <= 1e-2, f"kernel and plain probabilities differ by {dprob}")


def main() -> int:
    import numpy as np
    import torch

    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels._build import (
        build,
        load_library,
    )
    from crowded_scenes_ensemble_classification_tpu_torch.utils.device import require_cuda

    smi = require_cuda()  # raises without a CUDA card
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    lib, nvcc_s = build()
    load_library()
    print(f"kernels built: {lib.name} (nvcc {nvcc_s:.1f} s, build+load {time.perf_counter() - t0:.1f} s)")

    kernels = [check_maxpool(torch, dev), check_noise(torch, dev)]
    check_small_model(torch, dev)
    check_main_path(torch, np, dev, kernels)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

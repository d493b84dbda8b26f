#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one CUDA card and check them.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1):

1. print whether cv2 and h5py import on this machine, with their versions
   (phase 21 needs cv2; h5py, which only the Keras h5 reader needs, is not
   required); require a CUDA card; print its `nvidia-smi` name and power
   limit;
2. build the hand-written kernels from `csrc/` (timed);
3. max-pool kernel == its plain version and F.max_pool3d (`torch.equal`) at
   every shape the main path gives it, bf16 and f32, plus the tiler's
   ragged cases (`ODD_POOL_SHAPES`) and a misaligned input; timed at the
   main path's shapes warm (the same input again and again, as the main
   path finds its block input in L2) and cold (a rotation of inputs over
   twice the L2);
4. salt/pepper kernel: gates off is identity, only gated clips change and
   only to 0/255, a length not divisible by 4 works, density in
   (0.005, 0.016), and kernel == plain version on the same Philox seed; timed;
5. one port I3D at a small input on the card (kernels, f32, TF32 off)
   against the same model on the CPU (plain versions);
6. the main path: 4 full-width random-init I3D members (11 classes, bf16),
   3 `resident_ensemble_step`s on synthetic I420 rows (20 frames, 256²
   staging → 224², B=16): launch counts, finite probabilities summing to 1;
   then noise gates off, through the kernels and through the plain versions
   on the card: fused argmax equal, max |Δprob| ≤ 1e-2;
7. stem kernel == its plain version: f32 (TF32 off) at two small shapes,
   atol 1e-4 (summation order); bf16 at (16,20,224,224,3) × F=64, x ~ N(0,1),
   w ~ N(0,0.05), atol 0.0625 (the JAX on-TPU bound,
   tests/test_pallas_ops.py:189-197), and at ragged shapes and F values
   (`STEM_BF16_CASES`); timed beside the library route on the same inputs
   (s2d staging + cuDNN, `library_ms`), s2d staging alone, the bf16 kernel
   alone on inputs already staged and packed (with its grid and shared
   memory), and cuDNN's conv alone on the padded input, canonical and
   prestaged forms;
8. the per-member path: 4 full-width I3D members from
   `build_model("I3D", stem_impl="pallas")` on the default device (the
   card), `make_member_forward` unshared over 3 batches of 16 uint8
   20×224² clips: launch counts, probabilities; then the same members in
   the shared-staging (cuDNN stem) form: max |Δprob| ≤ 1e-2, fused argmax
   equal where the top-2 gap exceeds twice the largest fused difference,
   and, since random-init probabilities sit near uniform, the two stems'
   outputs within 1e-2 and member 0's logits within 5e-2 relative error;
9. the serving export of those members: export, save, load, serve the same
   batches: probabilities within 1e-2 of the eager forward, equal
   predictions, the kernels' launches counted from the loaded program; the
   same members as a lean artifact (`bake_params=False`) served with their
   stacked state dicts: smaller, equal to the baked artifact within 1e-2
   with equal predictions (and `torch.equal` printed), its launches
   counted; then the other forms at full width, B=4, each exported, saved,
   loaded and served against its eager forward over 3 batches (within 1e-2,
   equal predictions; export seconds, artifact MB, clips/s served and
   eager): 2 TwoStream members (bf16) taking gray pairs of panned textures,
   their flow computed in the program by turbo Farnebäck, 18 max-pool
   launches a member a batch; and a dynamic-int8 I3D (what the JAX CLI's
   `export --quant` bakes), 57 int8-conv and 57 quantize launches a batch;
10. max-pool gradient kernel against its plain version (run right after
   phase 7): the 9 Mixed-block shapes at B=16, the ragged ones
   and a misaligned input, bf16 and f32, on tie-heavy integer x with
   all-zero regions and dy in multiples of 1/8 (sums exact in any order):
   f32 reaches the same inputs and agrees within 1e-6·max|dy|, bf16 within
   one bf16 rounding of the f32 plain result; timed cold beside the plain
   version and the library route (F.max_pool3d's forward with indices, then
   its backward), warm too, a line per shape with its tile, GB/s and share
   of the bound;
11. stem backward: the kernel stem's weight gradient in train mode against
   the canonical ConvBN's, B=2 bf16, relative error ≤ 2e-2;
12. the resident training path (`ResidentClips` of 3·B uint8 20×256² clips,
   `make_resident_train_step(..., make_optimizer("I3D", 0.003), (224, 224),
   augment=True)`, bf16 compute on f32 master weights): 3 steps with 9
   forward and 9 backward max-pool launches, 1 noise launch and 0 stem
   launches each, finite losses; `fit` over 2 epochs with a resident
   validation set, the best checkpoint reloaded to its val loss and a
   save_best/restore_best round trip; a repeated batch whose loss falls over
   10 steps; one f32 step through the kernels against the same step
   through the plain versions (cuDNN deterministic): gradients and updated
   params within 1e-4 relative error (‖a − b‖/‖b‖ per tensor); train
   ms/step and clips/s at B=16 and B=64, 3 repeats of 5 steps;
13. every model family at full width (`build_model` of all 8 `MODEL_TYPES`,
   random weights drawn on the card from a seeded CUDA generator, BN
   spread): a bf16 forward (B=4 for R3D-101/152, B=16 otherwise) with
   finite probabilities summing to 1, timed (ms per batch, clips/s, peak
   memory); for C3D and R3D-18 an f32 B=2 forward on the card (TF32 off)
   against the same module on the CPU, logits within 1e-3 relative error;
14. the 16-member heterogeneous step (`hetero_ensemble_step`: 4 members
   each of I3D, TwoStream-I3D, C3D and R3D-18, bf16, on seeded 0-255 rgb
   (B,20,224,224,3) and precomputed flow (B,20,224,224,2)): at B=16 and
   B=64 (the JAX bench's batch; 48 or 32 if 64 does not fit, said so),
   5 steps (one repeat: the repeats went to phase 17), 108 max-pool
   launches a step, peak memory;
15. probabilities → store → evaluation: `member_probabilities` of each
   family over two seeded batches with seeded labels, saved as npz and
   read back through a `ProbProvider`; their SUM predictions agree with
   `hetero_ensemble_step`'s on the same clips; `evaluate_ensembles` under
   all five schemes (grid search over 14,630 candidates at M=4),
   `global_evaluate_ensembles` and `combine_ensembles` (15 subsets) on
   the card equal the same evaluation on the CPU, exactly;
16. dense optical flow (`flow/`, plain PyTorch on the card): Farnebäck in
   the full schedule (`fast_warp=True`, bench.py:377) and `TURBO_PARAMS`
   on the JAX bench's 76 sinusoidal 224² pairs moved by (1, 2)
   (bench.py:343-356): fields/s, 3 repeats of 3 calls with the spread, peak
   memory, and the least time the schedule's level planes need at
   3.35 TB/s; the card against the port on the CPU for 2 pairs within
   1e-4 px; the interior EPE against the shift on periodic textured pairs
   under the JAX suite's 0.05 px (tests/test_flow_motions.py:88; the
   bench's smooth sinusoids leave Farnebäck about 0.5 px off in both
   packages, printed beside it); TV-L1 on one pair in f32 (within 1e-3 px)
   and with bf16 duals (within 0.05 px on average), card against CPU;
17. the heterogeneous step with its flow computed on the card
   (`flow224=None`: turbo Farnebäck of the clips' gray frames, the last
   paired with the first, bench.py:563-568) at B=16 and B=64 (or 48, 32),
   3 repeats of 5 steps, 108 max-pool launches a step, peak memory, and
   the flow's own ms a step;
18. the resident TwoStream pipeline (`twostream_ensemble_step`, JAX
   bench.py:1366-1390): 4 full-width TwoStream members (bf16, prestaged)
   on resident I420 rows of a moving texture (20 frames, 256² staging →
   224²) at B=16 and the bench's B=48 (or 32), 3 repeats of 5 steps, 72
   max-pool and 1 noise launch a step, probabilities finite and summing to
   1; then noise gates off through the kernels and through the plain
   versions on the card: fused argmax equal, max |Δprob| ≤ 1e-2;
19. resident training of the rest of the zoo (JAX bench.py:624-720), bf16
   on f32 master weights drawn on the card, augment on, staging the model
   size + 32 with 2·B rows, each family with its optimizer and l2 rule
   (`train_policy`): C3D at B=32, TwoStream-I3D at B=16 with turbo
   Farnebäck of resident f32 gray pairs in the step, R3D-18 at B=32: 3
   repeats of 5 steps (ms/step, clips/s, spread), peak memory, finite
   losses, 18/18/1 max-pool, gradient and noise launches a TwoStream step
   and 0/0/1 a C3D and R3D step, a repeated batch whose loss falls over 10
   steps (C3D's read in eval mode: its dropout draws new masks each step);
   for TwoStream the flow alone on a step's pairs, one step with
   `flow_from_augmented`, `fit` over 2 epochs with its best checkpoint
   reloaded to its val loss (1e-3), and one f32 step (B=4) through the
   kernels against the plain versions, gradients and params within 1e-4
   relative error; R3D-50 at B=8 for 2 steps (the bottleneck blocks); two
   full-width C3D members through `make_multi_member_train_step` for 3
   steps (B=8, dropout on), each within 1e-6 relative error of itself
   trained alone by `make_train_step` (cuDNN deterministic);
20. int8 inference.  First the JAX accuracy gate (tests/test_quant.py:
   97-125, :222-258): the I3D of `tests/oracle_i3d.random_i3d_h5_layers(
   seed=3)` through `weights_io` and `load_pretrained`, on two raw 0-255
   batches (2, 16, 32, 32, 3) from default_rng(11): the dynamic I3D and the
   static one calibrated on the first within 0.05 of the f32 forward (TF32
   off) in softmax, top-1 unchanged, the static one's held-out batch finite
   with top-1 stable.  Then static int8 on the main path (the JAX bench's
   `_int8_breakout`, bench.py:1424-1500): 4 full-width I3D members (bf16
   compute, f32 weights; the trunks from reference-layout layer dicts,
   `random_i3d_h5_layers(seed=3..6)` without their heads, through
   `weights_io` and `load_pretrained`, the heads drawn on the card)
   built with quant='calib' are calibrated by
   `calibrate_members` on 2 batches of the main path's clips and baked;
   member 0 exported alone (shared staging, B=2), saved and loaded: its
   probabilities `torch.equal` to the eager forward's, 57 int8 conv and
   57 quantize launches; the int8 conv kernel == its plain version
   (`torch.equal`) at all 57 convs of one member on B=2 clips (recorded
   from its forward) and at `INT8_EXTRA_CASES` (C3D conv1, the R3D-18
   stem, a 3³/2 conv, a 1³/2 projection, ragged C, odd extents, odd F, the
   4-byte and byte-gather routes, a split K), the quantize kernel == its
   plain version, static and dynamic, at the member's 57 inputs; each conv
   of the member at B=16 held `torch.equal` to its plain version, and each
   conv and quantize pass timed there (warm and cold) beside
   its route and tile (`int8_conv_route`), its bound (int8 operations at
   1,979 TOPS, or bytes, on the conv's own channels: the stems' x8 carries
   4 zero channels), its plain version, cuDNN's bf16 conv of the same
   shape (another function) and, for the 1³ convs, `torch._int_mm` + the
   dequantize (the same function, checked equal), a line each (the stem
   on the row-slab route, the rest tiled), then the sums by kind (stem,
   3x3x3, 1x1x1) beside the earlier mma.sync design; then
   `resident_ensemble_step` with the static members at B=16 and B=48 (or
   32), 3 repeats of 5 steps, 228 int8-conv, 228 quantize, 36 max-pool, 1
   noise and 0 stem launches a step, probabilities finite and summing to
   1; against the bf16 main path on the same weights, rows and decisions:
   max |dprob| printed (not gated), fused argmax equal where the top-2 gap
   exceeds twice the largest fused difference; a small static I3D (f32) on the
   card against the CPU within 1e-3; and the static forward of C3D,
   R3D-18, TwoStream-I3D (precomputed flow) and I3D at full width, each
   calibrated on one batch of B=16: finite probabilities, timed;
21. data ingest (needs cv2: it raises without it).  Print `os.cpu_count()`
   and cv2's version; `generate_synthetic_dataset(as_videos=True,
   write_flow=False)` writes a Crowd-11-shaped dataset into a temporary
   directory: 55 scenes × 3 clips, 11 classes, 48 frames at 240×320 (not
   the staging size, not square: stride selection and resize both run),
   all `.mp4` with the frame count `video_frame_count` reads; then
   `build_clip_table` → `generate_folds(k=5)` (disjoint scenes) →
   `write_split_matrix` (20 splits) → the (test 0, val 1) split's CSVs,
   the test split's last batch of 16 padded.  Host decode ms a clip on one
   thread.  `member_probabilities` of 4 full-width I3D members (bf16) over
   the test split's `BatchPipeline(SampleSpec(20, (256, 256)), 16,
   num_workers=8)` with prefetch: 9 max-pool launches a member a batch,
   finite probabilities summing to 1 ± 1e-2, `np.array_equal` to
   `member_probabilities` over the same batches held in host memory;
   clips/s decode-inclusive, from memory and of the host decode alone, and
   the card's busy share of a profiled decode-inclusive pass (union of
   device intervals over the wall).  A second pipeline with `cache_file`:
   the populate seconds, epochs 0 and 1 from the native `read_batch`
   bit-equal to the decoded batches, and its `member_probabilities` equal
   to the decode route's (clips/s).  `fit` of one full-width trainable I3D
   for 1 epoch over the train split's pipeline (augment, balanced classes,
   B=16), validated on the val split's: a finite history, per train step 9
   max-pool, 9 gradient and 1 noise launches and 9 max-pool launches a val
   batch; clips/s decode-inclusive.  `ResidentClips.from_pipeline` of the
   train split on the card: rows bit-equal to the pipeline's decoded
   batches.  2 full-width TwoStream members over `SampleSpec(20, (256,
   256), two_stream=True, flow_precomputed=False)` (rgb and gray pairs from
   one decode pass, turbo Farnebäck on the card), B=8: 18 max-pool
   launches a member a batch, equal to the same batches from memory.  The
   phase adds about 70-90 s, most of it writing the dataset;
22. the experiment pipeline (`orchestration`) on phase 21's dataset: an
   I3D `ExperimentConfig` of 3 folds, `augmented_precomputed` ×1, 1
   epoch, B=8, bf16.  `prepare_ensemble` augments every clip on the card
   (one noise launch a clip; the fold CSVs gain
   `rgbclips_augmented_0_path`; a second `augment_folds` encodes nothing;
   the first fold-0 copy with both noise gates on equals the plain
   route's frames: the same decisions, then `salt_pepper`'s plain version
   on the card, and differs from those frames with the gates cleared); `launch_ensemble_training`
   trains members (0, 1) and (0, 2) (9 max-pool launches a step and an
   eval batch, 9 gradient launches a step, finite losses);
   `pending_members` lists the 4 others and `runner='commands',
   recover=True` gives their 4 commands; `cache_probabilities` of test
   fold 0 in bf16 and with `quant='static'` (calibrated on 2 batches; 57
   int8-conv and 57 quantize launches a member a batch): finite rows
   summing to 1 ± 1e-2, two paths, a second call returning the cache with
   no launch; `evaluate_ensembles` with SUM and VALIDATION_ERROR_INVERSE
   through `make_prob_provider` and `min_val_losses_provider`; the
   confusion and agreement matrices, their PDFs only where matplotlib
   imports (a line says whether it does).  Prints seconds by stage,
   offline augmentation clips/s, train and probabilities clips/s with the
   card's busy share (profiler), and the phase's launches by kernel.

Bounds use the H100 SXM data sheet: 989 TFLOP/s dense bf16, 1,979 TOPS
dense int8, 67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s.  The line
before last is the kernels' JSON record (6 kernels; the max pool's
`launches` counts the main path's 3 steps, the heterogeneous phase's 5
steps at B=16 with precomputed flow and 15 with the flow on the card, and
the TwoStream pipeline's 15 steps at B=16, the first 5 timed train steps
of each family of phase 19 and the int8 main path's 15 steps at B=16, and phase 21's
probabilities, fit and TwoStream passes and phase 22's; the noise kernel's
the main path's, the TwoStream pipeline's, phase 19's, the int8 main
path's, phase 21's fit and phase 22's offline augmentation; the gradient
kernel's the I3D training path's, phase 19's, phase 21's fit and phase
22's training; the int8 conv's and the quantize pass's the int8 main
path's 15 steps at B=16 and phase 22's static cache, their times the sums
over one member's 57 convs at B=16; each record keeps a phase's own count
under `launches_<phase>`); the last line is `{"ok": true, "device":
{...}}`.  Needs one card and no network.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import sys
import tempfile
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
# T=1 and 2, C not a multiple of the 16-byte unit (3, 130), H not a multiple
# of the H-tile (30, 5), a partial last C-block (528), H and W under a tile
ODD_POOL_SHAPES = [(2, 1, 5, 5, 64), (2, 3, 5, 7, 3), (2, 3, 5, 7, 130), (2, 4, 30, 28, 64),
                   (2, 5, 14, 14, 528), (1, 2, 6, 6, 16)]
NOISE_SHAPE = (BATCH, FRAMES, SIZE, SIZE, 3)
STEM_F32_CASES = [((2, 4, 28, 28, 3), 16), ((1, 6, 28, 36, 3), 16)]
# bf16 shapes the persistent tiler must mask: H/2 and W/2 not multiples of
# 16, T=2 (every tile skips taps at both ends), F-parts of 8, 32, 40 and 64
# channels, and C = 2 and 1 (the 4C = 8 and 4 kernels).
STEM_BF16_CASES = [((2, 2, 40, 52, 3), f) for f in (8, 32, 64)] + [
    ((1, 6, 70, 46, 3), 64), ((2, 4, 36, 38, 3), 40), ((1, 4, 34, 30, 2), 64), ((1, 2, 30, 28, 1), 16)]
STEM_FEATURES = 64
INPUT_SCALE = 1 / 255.0  # the per-member path's pixel scale: unsaturated softmax
BF16_FLOPS, F32_FLOPS, HBM_BYTES = 989e12, 67e12, 3.35e12  # H100 SXM data sheet, per second
L2_BYTES = 50e6  # H100 SXM data sheet


def bound(bytes_moved: float, ops: float, rate: float) -> tuple[float, str]:
    """(least ms, what bounds it): the larger of bytes over HBM rate and
    operations over the peak rate for their type."""
    by_bytes, by_ops = bytes_moved / HBM_BYTES * 1e3, ops / rate * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3, queue_ahead: bool = True) -> float:
    """Mean device milliseconds per call, by CUDA events around `iters` calls.

    With `queue_ahead` the device first spins for twice the host's time to
    queue the calls, so that every call is queued before the first one
    runs: the events then time the device's work back to back, not the
    host's launch overhead (which exceeds the device time of a small
    kernel).  It spins longer if the host fell behind, and fails if it
    still does.  Without it (for a function of more launches than the
    device's queue holds) the events time the calls as the host issues them."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / warmup * iters  # the host's time to queue `iters` calls
    for spin in (2, 8) if queue_ahead else (0,):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if queue_ahead:
            torch.cuda._sleep(int((spin * host_s + 1e-3) * 2e9))  # cycles, at most 2 GHz
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()  # the device has not reached `start`: every call was queued in time
        torch.cuda.synchronize()
        if ahead or not queue_ahead:
            return start.elapsed_time(end) / iters
    raise RuntimeError("chip_smoke check failed: cuda_ms: the host fell behind the device's spin")


def cold_inputs(x) -> list:
    """Distinct copies of x whose total exceeds twice the card's 50 MB L2, so
    that a rotation over them finds each input out of L2."""
    n = max(2, math.ceil(2 * L2_BYTES / (x.numel() * x.element_size())) + 1)
    return [x] + [x.clone() for _ in range(n - 1)]


def cuda_ms_cold(fn, inputs, iters: int = 20) -> float:
    """Mean device milliseconds per call of fn(x), x rotating over `inputs`."""
    rotation = itertools.cycle(inputs)
    return cuda_ms(lambda: fn(next(rotation)), iters=max(iters, len(inputs)))


def check_maxpool(torch, dev) -> dict:
    import torch.nn.functional as F

    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import (
        max_pool_3x3x3_reference,
        max_pool_3x3x3_same,
        max_pool_tiling,
    )

    def library(x):  # F.max_pool3d on the channels_last_3d NCDHW view
        return F.max_pool3d(x.permute(0, 4, 1, 2, 3), 3, 1, padding=1)

    gen = torch.Generator(device=dev).manual_seed(0)
    err = 0.0
    cases = [(s, 0) for s in POOL_SHAPES + ODD_POOL_SHAPES] + [((2, 3, 9, 7, 64), 1)]  # (shape, offset)
    for shape, offset in cases:
        for dtype in (torch.bfloat16, torch.float32):
            # an offset of one element starts x 2 or 4 bytes off a 16-byte boundary
            flat = torch.randn(offset + math.prod(shape), device=dev, generator=gen).to(dtype)
            x = flat[offset:].view(shape)
            got, ref = max_pool_3x3x3_same(x), max_pool_3x3x3_reference(x)
            torch.cuda.synchronize()
            err = max(err, (got.float() - ref.float()).abs().max().item())
            what = f"{shape} {dtype}{' misaligned' if offset else ''}"
            check(torch.equal(got, ref), f"max-pool kernel != plain at {what}")
            check(torch.equal(library(x).permute(0, 2, 3, 4, 1), got), f"F.max_pool3d(padding=1) != the kernel at {what}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tot = dict.fromkeys(("warm", "cold", "plain", "lib_warm", "lib_cold", "bytes", "ops"), 0.0)
    for shape in POOL_SHAPES:
        x = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
        xs = cold_inputs(x)
        warm, cold = cuda_ms(lambda: max_pool_3x3x3_same(x)), cuda_ms_cold(max_pool_3x3x3_same, xs)
        plain = cuda_ms(lambda: max_pool_3x3x3_reference(x))
        lib_warm, lib_cold = cuda_ms(lambda: library(x)), cuda_ms_cold(library, xs)
        nbytes = 2 * x.numel() * x.element_size()  # one read and one write
        shape_bound = nbytes / HBM_BYTES * 1e3
        t = max_pool_tiling(shape, 2, sms=sms)
        print(f"maxpool bf16 {shape} (ht {t.ht}, wt {t.wt}, cb {t.cb}, grid {t.grid} x {t.threads} threads, "
              f"{t.smem} B shared): kernel warm {warm:.4f} ms ({nbytes / warm / 1e6:.1f} GB/s, "
              f"{shape_bound / warm:.1%} of bound), cold {cold:.4f} ms ({nbytes / cold / 1e6:.1f} GB/s, "
              f"{shape_bound / cold:.1%} of bound) over {len(xs)} inputs; plain {plain:.4f} ms; "
              f"F.max_pool3d warm {lib_warm:.4f} ms, cold {lib_cold:.4f} ms; bound {shape_bound:.4f} ms")
        for k, v in zip(tot, (warm, cold, plain, lib_warm, lib_cold, nbytes, 26 * x.numel())):
            tot[k] += v  # ops: 26 maxes per output
        del xs
    bound_ms, bound_by = bound(tot["bytes"], tot["ops"], F32_FLOPS)
    print(f"maxpool: all {len(cases)} shapes x 2 dtypes equal to the plain version "
          f"and to F.max_pool3d; {len(POOL_SHAPES)} Mixed-block pools of one member at B={BATCH}: kernel cold {tot['cold']:.4f} ms "
          f"({bound_ms / tot['cold']:.1%} of bound), warm {tot['warm']:.4f} ms ({bound_ms / tot['warm']:.1%}); "
          f"plain {tot['plain']:.4f} ms; F.max_pool3d cold {tot['lib_cold']:.4f} ms, warm {tot['lib_warm']:.4f} ms; "
          f"bound {bound_ms:.4f} ms ({bound_by}, {tot['bytes'] / 1e6:.1f} MB); "
          f"kernel vs F.max_pool3d cold {tot['lib_cold'] / tot['cold']:.2f}x")
    if tot["warm"] < bound_ms:
        print("maxpool: the warm sum beats the HBM bound: inputs under 50 MB stay in L2 between calls")
    return {"name": "max_pool_3x3x3_same", "route": "cuda",
            "source": f"{PORT}/csrc/maxpool3x3x3.cu",
            "replaces": "crowded_scenes_ensemble_classification_tpu/ops/pallas/maxpool.py:51",
            "max_abs_err": err, "ms": tot["cold"], "warm_ms": tot["warm"], "plain_ms": tot["plain"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": tot["lib_cold"],
            "library_warm_ms": tot["lib_warm"]}


def tie_heavy(shape, dtype, gen, dev, torch):
    """Integer-valued x with many ties and all-zero regions (the ReLU
    plateau: negatives clamped to 0, and the first half of H zeroed)."""
    x = torch.randint(-3, 4, shape, device=dev, generator=gen).clamp_min_(0)
    x[:, :, : shape[2] // 2] = 0
    return x.to(dtype)


def time_maxpool_backward(torch, dev, gen, tile=None) -> dict:
    """Cold and warm ms of the max-pool gradient kernel at the main path's
    shapes in bf16 on normal inputs, beside the plain version and the library route
    (F.max_pool3d's forward with indices, then its backward), a line per
    shape with its tile (`tile(shape)`, by default the tiler's), GB/s and
    share of the bound; returns the sums over the shapes."""
    import torch.nn.functional as F

    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import (
        max_pool_3x3x3_backward_reference,
        max_pool_3x3x3_same_backward,
    )

    if tile is None:
        from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import max_pool_backward_tiling

        sms = torch.cuda.get_device_properties(dev).multi_processor_count

        def tile(shape):
            t = max_pool_backward_tiling(shape, 2, sms=sms)
            return (f"ht {t.ht}, wt {t.wt}, cv {t.cv}, {t.groups} row groups, grid {t.grid} x {t.threads} "
                    f"threads, {t.smem} B shared")

    tot = dict.fromkeys(("cold", "warm", "plain", "lib_fwd", "lib_bwd", "bytes", "ops"), 0.0)
    for shape in POOL_SHAPES:
        x = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
        dy = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
        pairs = list(zip(cold_inputs(x), cold_inputs(dy)))
        cold = cuda_ms_cold(lambda p: max_pool_3x3x3_same_backward(*p), pairs)
        warm = cuda_ms(lambda: max_pool_3x3x3_same_backward(x, dy))
        plain = cuda_ms(lambda: max_pool_3x3x3_backward_reference(x, dy))
        xc, dyc = x.permute(0, 4, 1, 2, 3), dy.permute(0, 4, 1, 2, 3)
        _, idx = F.max_pool3d(xc, 3, 1, padding=1, return_indices=True)
        lib_fwd = cuda_ms_cold(lambda p: F.max_pool3d(p[0].permute(0, 4, 1, 2, 3), 3, 1, padding=1,
                                                      return_indices=True), pairs)
        lib_bwd = cuda_ms(lambda: torch.ops.aten.max_pool3d_with_indices_backward(
            dyc, xc, [3] * 3, [1] * 3, [1] * 3, [1] * 3, False, idx))
        nbytes = 3 * x.numel() * x.element_size()  # read x and dy, write dx
        shape_bound = nbytes / HBM_BYTES * 1e3
        print(f"maxpool backward bf16 {shape} ({tile(shape)}): kernel cold {cold:.4f} ms "
              f"({nbytes / cold / 1e6:.1f} GB/s, {shape_bound / cold:.1%} of bound), warm {warm:.4f} ms; "
              f"plain {plain:.4f} ms; "
              f"F.max_pool3d forward with indices {lib_fwd:.4f} ms + backward {lib_bwd:.4f} ms; "
              f"bound {shape_bound:.4f} ms")
        for k, v in zip(tot, (cold, warm, plain, lib_fwd, lib_bwd, nbytes, 54 * x.numel())):
            tot[k] += v  # ops: 27 compares and 27 selected adds
        del pairs
    return tot


def check_maxpool_backward(torch, dev) -> dict:
    """The max-pool gradient kernel against its plain version at the pool
    shapes, the ragged ones and a misaligned input, bf16 and f32, on
    tie-heavy x.  dy takes multiples of 1/8 in [-1, 1), so sums of up to 27
    of them are exact in f32 whatever their order: f32 must agree with the
    plain version on which inputs get a gradient and within 1e-6·max|dy|;
    bf16 (summed in f32, rounded once) within one bf16 rounding of the f32
    plain version on the same values.  Timed at the main path's shapes in
    bf16 on normal inputs, cold, beside the plain version and the library
    route (F.max_pool3d's forward with indices, then its backward)."""
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import (
        max_pool_3x3x3_backward_reference,
        max_pool_3x3x3_same_backward,
    )

    gen = torch.Generator(device=dev).manual_seed(8)
    err = 0.0
    cases = [(s, 0) for s in POOL_SHAPES + ODD_POOL_SHAPES] + [((2, 3, 9, 7, 64), 1)]  # (shape, offset)
    for shape, offset in cases:
        x32 = tie_heavy(shape, torch.float32, gen, dev, torch)
        dy32 = torch.randint(-8, 8, shape, device=dev, generator=gen).float() / 8
        ref = max_pool_3x3x3_backward_reference(x32, dy32)
        scale = dy32.abs().max().item()
        for dtype in (torch.float32, torch.bfloat16):
            # an offset of one element starts x, dy 2 or 4 bytes off a 16-byte boundary
            x = torch.empty(offset + x32.numel(), dtype=dtype, device=dev)[offset:].view(shape).copy_(x32)
            dy = torch.empty(offset + x32.numel(), dtype=dtype, device=dev)[offset:].view(shape).copy_(dy32)
            got = max_pool_3x3x3_same_backward(x, dy).float()
            torch.cuda.synchronize()
            d = (got - ref).abs()
            err = max(err, d.max().item())
            what = f"{shape} {dtype}{' misaligned' if offset else ''}"
            if dtype == torch.float32:
                check(torch.equal(got != 0, ref != 0), f"max-pool gradient reaches other inputs at {what}")
                check(d.max().item() <= 1e-6 * scale, f"max-pool gradient != plain at {what}: {d.max().item()}")
            else:  # one rounding to bf16 moves a value by at most 2^-8 of it
                check(bool((d <= ref.abs() * 2.0**-8).all()), f"max-pool gradient != plain at {what}")
    tot = time_maxpool_backward(torch, dev, gen)
    bound_ms, bound_by = bound(tot["bytes"], tot["ops"], F32_FLOPS)
    library_ms = tot["lib_fwd"] + tot["lib_bwd"]
    print(f"maxpool backward: all {len(cases)} shapes x 2 dtypes agree with the plain version on tie-heavy "
          f"inputs (max |d| {err:.3g}); {len(POOL_SHAPES)} Mixed-block pools of one member at B={BATCH}: kernel "
          f"cold {tot['cold']:.4f} ms ({tot['bytes'] / tot['cold'] / 1e6:.1f} GB/s, {bound_ms / tot['cold']:.1%} "
          f"of bound), warm {tot['warm']:.4f} ms; plain {tot['plain']:.4f} ms; library route {library_ms:.4f} ms "
          f"(forward with indices {tot['lib_fwd']:.4f} + backward {tot['lib_bwd']:.4f}); bound {bound_ms:.4f} ms "
          f"({bound_by}, {tot['bytes'] / 1e6:.1f} MB); kernel vs library route {library_ms / tot['cold']:.2f}x, vs its "
          f"backward alone {tot['lib_bwd'] / tot['cold']:.2f}x")
    return {"name": "max_pool_3x3x3_same_backward", "route": "cuda",
            "source": f"{PORT}/csrc/maxpool3x3x3_bwd.cu",
            "replaces": "crowded_scenes_ensemble_classification_tpu/models/common.py:28",
            "max_abs_err": err, "ms": tot["cold"], "warm_ms": tot["warm"], "plain_ms": tot["plain"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms, "library_backward_ms": tot["lib_bwd"],
            "library_forward_indices_ms": tot["lib_fwd"]}


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
    # the plain Philox is some hundred launches a call: timed as issued
    plain_ms = cuda_ms(lambda: salt_pepper_plain(x, 5, salt, pepper, 100), iters=5, queue_ahead=False)
    mb = 2 * x.numel() * 4 / 1e6
    # about 31 32-bit integer operations per element (Philox4x32-10 per 4
    # elements, two compares), counted at the f32 rate outside the tensor cores
    bound_ms, bound_by = bound(mb * 1e6 + 2 * BATCH, 31 * x.numel(), F32_FLOPS)
    print(f"noise: identity, gating, odd length, kernel == plain ok; density salt {salt_density:.5f} "
          f"pepper {pepper_density:.5f}; {NOISE_SHAPE} f32: kernel {ms:.4f} ms ({mb / ms:.1f} GB/s), "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return {"name": "salt_pepper", "route": "cuda", "source": f"{PORT}/csrc/salt_pepper.cu",
            "replaces": "crowded_scenes_ensemble_classification_tpu/ops/pallas/noise.py:52",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def check_stem(torch, dev) -> dict:
    import torch.nn.functional as F

    from crowded_scenes_ensemble_classification_tpu_torch.models.common import s2d_stem_conv, to_ncdhw
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.stem_conv import (
        pack_stem_weights,
        s2d_stem_kernel,
        s2d_stem_stage,
        s2d_stem_stage_even,
        stem_bf16_launch_config,
        stem_conv_7x7x7_s2,
        stem_conv_7x7x7_s2_reference,
        stem_conv_s2d_bf16,
    )

    gen = torch.Generator(device=dev).manual_seed(3)
    for shape, f in STEM_F32_CASES:
        x = torch.randn(shape, device=dev, generator=gen)
        w = torch.randn((f, shape[-1], 7, 7, 7), device=dev, generator=gen) * 0.1
        got, ref = stem_conv_7x7x7_s2(x, w), stem_conv_7x7x7_s2_reference(x, w)
        torch.cuda.synchronize()
        err32 = (got - ref).abs().max().item()
        print(f"stem f32 {shape} x F={f}: max |kernel - plain| {err32:.3g}")
        check(got.shape == ref.shape and err32 <= 1e-4, f"stem kernel != plain in f32 at {shape}")

    for shape, f in STEM_BF16_CASES:
        x = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
        w = (torch.randn((f, shape[-1], 7, 7, 7), device=dev, generator=gen) * 0.05).to(torch.bfloat16)
        got, ref = stem_conv_7x7x7_s2(x, w), stem_conv_7x7x7_s2_reference(x, w)
        torch.cuda.synchronize()
        e = (got.float() - ref.float()).abs().max().item()
        print(f"stem bf16 {shape} x F={f}: max |kernel - plain| {e:.4g}")
        check(got.shape == ref.shape and e <= 0.0625, f"stem kernel != plain in bf16 at {shape} x F={f}: {e}")

    x = torch.randn(NOISE_SHAPE, device=dev, generator=gen).to(torch.bfloat16)
    w = (torch.randn((STEM_FEATURES, 3, 7, 7, 7), device=dev, generator=gen) * 0.05).to(torch.bfloat16)
    got, ref = stem_conv_7x7x7_s2(x, w), stem_conv_7x7x7_s2_reference(x, w)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    print(f"stem bf16 {NOISE_SHAPE} x F={STEM_FEATURES}: max |kernel - plain| {err:.4g}, "
          f"max |plain| {ref.float().abs().max().item():.3g}")
    check(err <= 0.0625, f"stem kernel != plain in bf16: {err}")
    xs_even, wp = s2d_stem_stage_even(x), pack_stem_weights(w)
    alone = lambda: stem_conv_s2d_bf16(xs_even, wp, SIZE, STEM_FEATURES)  # noqa: E731
    check(torch.equal(alone(), got), "the bf16 kernel alone differs from its wrapper")

    # The library route on the kernel's own inputs (x, w) → NTHWC y: s2d
    # staging, temporal pad and cuDNN on the prestaged form (`s2d_stem_conv`,
    # what the port's s2d stems run).  It is the fastest library route
    # measured, so it is `library_ms`.  Beside it, for the breakdown, cuDNN's
    # conv alone on inputs already padded (canonical) or staged and padded
    # (prestaged), both in channels_last_3d.
    library = lambda: s2d_stem_conv(x, w)  # noqa: E731
    check((library().float() - ref.float()).abs().max().item() <= 0.0625,
          "s2d staging + cuDNN disagrees with the plain version")
    cl = torch.channels_last_3d
    xp = F.pad(to_ncdhw(x), (2, 3, 2, 3, 2, 3)).contiguous(memory_format=cl)
    wc = w.contiguous(memory_format=cl)
    xs = F.pad(to_ncdhw(s2d_stem_stage(x)), (0, 0, 0, 0, 2, 3)).contiguous(memory_format=cl)
    w8 = s2d_stem_kernel(w).contiguous(memory_format=cl)
    canonical = lambda: F.conv3d(xp, wc, stride=2)  # noqa: E731
    prestaged = lambda: F.conv3d(xs, w8, stride=(2, 1, 1))  # noqa: E731
    check((canonical().permute(0, 2, 3, 4, 1).float() - ref.float()).abs().max().item() <= 0.0625,
          "cuDNN's canonical stem disagrees with the plain version")
    ms = cuda_ms(lambda: stem_conv_7x7x7_s2(x, w))
    kernel_ms = cuda_ms(alone)
    plain_ms = cuda_ms(lambda: stem_conv_7x7x7_s2_reference(x, w))
    staging_ms = cuda_ms(lambda: s2d_stem_stage(x))
    even_ms = cuda_ms(lambda: s2d_stem_stage_even(x))
    grid, smem = stem_bf16_launch_config(dev, 3, STEM_FEATURES)
    library_ms = cuda_ms(library)
    canonical_ms, prestaged_ms = cuda_ms(canonical), cuda_ms(prestaged)
    n, t, h, w_, c = NOISE_SHAPE
    flops = 2 * (n * t * h * w_ // 8) * STEM_FEATURES * 343 * c
    bytes_moved = (x.numel() + w.numel() + got.numel()) * 2
    bound_ms, bound_by = bound(bytes_moved, flops, BF16_FLOPS)
    print(f"stem bf16 B={BATCH}: kernel wrapper {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), of which "
          f"the kernel alone {kernel_ms:.4f} ms ({flops / kernel_ms / 1e9:.1f} TFLOP/s of real taps; grid "
          f"{grid} blocks, {smem} B dynamic shared memory) and the even-width s2d staging {even_ms:.4f} ms; "
          f"plain {plain_ms:.4f} ms, library route (s2d staging + cuDNN) {library_ms:.4f} ms "
          f"(s2d staging alone {staging_ms:.4f} ms); cuDNN alone: canonical on padded input "
          f"{canonical_ms:.4f} ms, prestaged form {prestaged_ms:.4f} ms; bound {bound_ms:.4f} ms "
          f"({bound_by}); wrapper below library route: {ms < library_ms}")
    return {"name": "stem_conv_7x7x7_s2", "route": "cuda", "source": f"{PORT}/csrc/stem_conv7x7x7s2.cu",
            "replaces": "crowded_scenes_ensemble_classification_tpu/ops/pallas/stem_conv_v8.py:140 and "
                        "crowded_scenes_ensemble_classification_tpu/ops/pallas/stem_conv.py:81",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


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
        if k["name"] in launches:
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


def fused_argmax_agrees(probs_a, probs_b, torch) -> tuple[bool, float]:
    """Fused (SUM) argmax equal wherever the top-2 gap of `probs_a`'s fused
    scores exceeds twice the largest fused difference: a closer pair may
    swap places.  Returns (agrees, largest fused difference)."""
    fa, fb = probs_a.float().sum(0), probs_b.float().sum(0)
    dfused = (fa - fb).abs().max().item()
    top2 = fa.topk(2, dim=-1).values
    differ = fa.argmax(-1) != fb.argmax(-1)
    return bool((top2[:, 0] - top2[:, 1])[differ].lt(2 * dfused).all()), dfused


def check_member_path(torch, np, dev, kernels) -> tuple:
    """The per-member path through `build_model` and the unshared member
    forward; returns (bundles, batches, eager probabilities, clips/s)."""
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.members import (
        make_member_forward,
        prepare_member_inputs,
    )
    from crowded_scenes_ensemble_classification_tpu_torch.models import build_model
    from crowded_scenes_ensemble_classification_tpu_torch.models.common import s2d_stem_stage, to_ncdhw
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import max_pool_3x3x3_same
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.stem_conv import stem_conv_7x7x7_s2

    gen = torch.Generator().manual_seed(6)
    bundles = [build_model("I3D", dtype=torch.bfloat16, generator=gen, stem_impl="pallas") for _ in range(MEMBERS)]
    check(all(p.is_cuda for b in bundles for p in b.module.parameters()), "build_model left weights off the card")
    clips = np.random.default_rng(7).integers(0, 256, (STEPS, BATCH, FRAMES, SIZE, SIZE, 3), dtype=np.uint8)
    batches = [{"rgb": torch.from_numpy(c).to(dev)} for c in clips]
    forward = make_member_forward([b.module for b in bundles], (SIZE, SIZE), input_scale=INPUT_SCALE)
    forward(batches[0])  # warm-up: cuDNN plans, allocator
    max_pool_3x3x3_same.launches = stem_conv_7x7x7_s2.launches = 0
    outs, cps = timed_steps(lambda i: forward(batches[i]), torch)
    launches = {"stem_conv_7x7x7_s2": stem_conv_7x7x7_s2.launches, "max_pool_3x3x3_same": max_pool_3x3x3_same.launches}
    print(f"per-member path (unshared, kernel stem): {STEPS} batches, {MEMBERS} members, B={BATCH}, bf16: "
          f"{cps:.2f} clips/s; launches {launches}")
    check(launches["stem_conv_7x7x7_s2"] == MEMBERS * STEPS, "stem launch count")
    check(launches["max_pool_3x3x3_same"] == 9 * MEMBERS * STEPS, "max-pool launch count on the per-member path")
    for probs in outs:
        check(probs.shape == (MEMBERS, BATCH, CLASSES), "per-member output shape")
        check(bool(torch.isfinite(probs).all()), "non-finite probabilities")
        check(bool(((probs.sum(-1) - 1.0).abs() <= 1e-2).all()), "probabilities do not sum to 1")
    next(k for k in kernels if k["name"] == "stem_conv_7x7x7_s2")["launches"] = launches["stem_conv_7x7x7_s2"]

    twins = [build_model("I3D", dtype=torch.bfloat16, stem_prestaged=True) for _ in bundles]
    for twin, b in zip(twins, bundles):
        twin.module.load_state_dict(b.module.state_dict())
    shared = make_member_forward([t.module for t in twins], (SIZE, SIZE), share_stem_staging=True,
                                 input_scale=INPUT_SCALE)
    shared(batches[0])
    shared_outs, shared_cps = timed_steps(lambda i: shared(batches[i]), torch)
    dprob = max((a - b).abs().max().item() for a, b in zip(outs, shared_outs))
    agree = [fused_argmax_agrees(a, b, torch) for a, b in zip(outs, shared_outs)]
    same = sum(int(torch.equal(a.sum(0).argmax(-1), b.sum(0).argmax(-1))) for a, b in zip(outs, shared_outs))
    fused = torch.stack(outs).float().sum(1)  # (STEPS, B, C)
    top2 = fused.topk(2, dim=-1).values
    print(f"same members, shared staging (cuDNN stem): {shared_cps:.2f} clips/s; max |dprob| {dprob:.3g}, "
          f"max |dfused| {max(d for _, d in agree):.3g}; fused argmax equal in {same} of {STEPS} batches; "
          f"spread: max |p - 1/{CLASSES}| {(torch.stack(outs) - 1 / CLASSES).abs().max().item():.3g}, "
          f"fused top-2 gap median {(top2[..., 0] - top2[..., 1]).median().item():.3g}")
    check(dprob <= 1e-2, f"kernel-stem and cuDNN-stem probabilities differ by {dprob}")
    check(all(ok for ok, _ in agree), "fused argmax differs where the top-2 gap is wide")

    # Random-init probabilities sit near uniform, so |dprob| alone cannot
    # tell a wrong stem from a right one.  Hold the two stems' outputs and
    # member 0's logits to each other by relative error, ||a - b|| / ||b||:
    # a wrong stem moves both by O(1), bf16 rounding by about 1e-3.
    x = prepare_member_inputs(batches[0], (SIZE, SIZE), False, INPUT_SCALE)["rgb"].to(torch.bfloat16)
    kernel_member, cudnn_member = bundles[0].module, twins[0].module
    with torch.inference_mode():
        xs = s2d_stem_stage(x)
        stem_k = kernel_member.trunk.Conv3d_1a_7x7(to_ncdhw(x)).float()
        stem_c = cudnn_member.trunk.Conv3d_1a_7x7(xs).float()
        logit_k, logit_c = kernel_member(x), cudnn_member(xs)
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731
    stem_rel, logit_rel = rel(stem_k, stem_c), rel(logit_k, logit_c)
    print(f"member 0, batch 0, kernel vs cuDNN stem: stem output rel err {stem_rel:.3g} (|y| mean "
          f"{stem_c.abs().mean().item():.3g}, max {stem_c.abs().max().item():.3g}); logits rel err "
          f"{logit_rel:.3g} (max |logit| {logit_c.abs().max().item():.3g}, std over classes "
          f"{logit_c.std(-1).mean().item():.3g})")
    check(stem_c.abs().max().item() > 0 and stem_rel <= 1e-2, f"kernel stem output differs from cuDNN's: {stem_rel}")
    check(logit_c.std(-1).min().item() > 0 and logit_rel <= 5e-2, f"kernel-stem logits differ from cuDNN's: {logit_rel}")
    return bundles, batches, outs, cps


def check_serving(torch, bundles, batches, eager, eager_cps) -> None:
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import max_pool_3x3x3_same
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.stem_conv import stem_conv_7x7x7_s2
    from crowded_scenes_ensemble_classification_tpu_torch.serving import export_ensemble, serving_batch_example

    t0 = time.perf_counter()
    program = export_ensemble(bundles, serving_batch_example(bundles[0], BATCH), input_scale=INPUT_SCALE)
    export_s = time.perf_counter() - t0
    serve, meta, size_mb = artifact(program, {"model_type": "I3D", "members": [f"m{i}" for i in range(MEMBERS)]})
    convs = [p for p in serve.module.parameters() if p.dim() == 5]
    cl = sum(p.is_contiguous(memory_format=torch.channels_last_3d) for p in convs)
    serve(batches[0])  # warm-up
    max_pool_3x3x3_same.launches = stem_conv_7x7x7_s2.launches = 0
    outs, cps = timed_steps(lambda i: serve(batches[i]), torch)
    launches = {"stem_conv_7x7x7_s2": stem_conv_7x7x7_s2.launches, "max_pool_3x3x3_same": max_pool_3x3x3_same.launches}
    dprob = max((o["probs"] - e).abs().max().item() for o, e in zip(outs, eager))
    same = all(torch.equal(o["preds"], e.sum(0).argmax(-1)) for o, e in zip(outs, eager))
    print(f"serving: export {export_s:.1f} s, artifact {size_mb:.1f} MB on {meta['device']}, "
          f"{cl} of {len(convs)} loaded conv weights channels_last_3d; {cps:.2f} clips/s served vs "
          f"{eager_cps:.2f} eager; max |dprob| vs eager {dprob:.3g}; preds equal: {same}; launches {launches}")
    check(launches["stem_conv_7x7x7_s2"] == MEMBERS * STEPS, "stem launches from the loaded program")
    check(launches["max_pool_3x3x3_same"] == 9 * MEMBERS * STEPS, "max-pool launches from the loaded program")
    check(dprob <= 1e-2, f"served probabilities differ from eager by {dprob}")
    check(same, "served predictions differ from eager")
    check_lean_serving(torch, bundles, batches, outs, size_mb)


def artifact(program, meta: dict):
    """Save `program` and load it back on the card → (serve, metadata, MB)."""
    from crowded_scenes_ensemble_classification_tpu_torch.serving import load_serving_artifact, save_serving_artifact

    with tempfile.TemporaryDirectory() as tmp:
        path = save_serving_artifact(os.path.join(tmp, "artifact.zip"), program, meta)
        size_mb = os.path.getsize(path) / 1e6
        serve, meta = load_serving_artifact(path)
    return serve, meta, size_mb


def check_lean_serving(torch, bundles, batches, baked_outs, baked_mb) -> None:
    """The same members as a lean artifact (bake_params=False), served with
    their stacked state dicts: equal to the baked artifact's outputs."""
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.members import stack_variables
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import max_pool_3x3x3_same
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.stem_conv import stem_conv_7x7x7_s2
    from crowded_scenes_ensemble_classification_tpu_torch.serving import export_ensemble, serving_batch_example

    t0 = time.perf_counter()
    program = export_ensemble(bundles, serving_batch_example(bundles[0], BATCH), input_scale=INPUT_SCALE,
                              bake_params=False)
    export_s = time.perf_counter() - t0
    serve, _, size_mb = artifact(program, {"model_type": "I3D"})
    params = stack_variables([b.module.state_dict() for b in bundles])
    serve(params, batches[0])  # warm-up
    max_pool_3x3x3_same.launches = stem_conv_7x7x7_s2.launches = 0
    outs, cps = timed_steps(lambda i: serve(params, batches[i]), torch)
    launches = {"stem_conv_7x7x7_s2": stem_conv_7x7x7_s2.launches, "max_pool_3x3x3_same": max_pool_3x3x3_same.launches}
    dprob = max((o["probs"] - b["probs"]).abs().max().item() for o, b in zip(outs, baked_outs))
    equal = all(torch.equal(o["probs"], b["probs"]) for o, b in zip(outs, baked_outs))
    same = all(torch.equal(o["preds"], b["preds"]) for o, b in zip(outs, baked_outs))
    print(f"lean serving (bake_params=False), the same {MEMBERS} members with their stacked state: export "
          f"{export_s:.1f} s, artifact {size_mb:.1f} MB (baked {baked_mb:.1f} MB); {cps:.2f} clips/s; vs the baked "
          f"artifact max |dprob| {dprob:.3g}, torch.equal {equal}, preds equal {same}; launches {launches}")
    check(size_mb < baked_mb, "the lean artifact is not smaller than the baked one")
    check(launches["max_pool_3x3x3_same"] == 9 * MEMBERS * STEPS, "max-pool launches from the lean program")
    check(launches["stem_conv_7x7x7_s2"] == MEMBERS * STEPS, "stem launches from the lean program")
    check(dprob <= 1e-2 and same, f"the lean artifact differs from the baked one by {dprob}")


def gray_pair_batch(torch, np, rng, dev, size: int):
    """`size` uint8 TwoStream clips: rgb noise and gray pairs of a periodic
    texture panned by a seeded step (±3 px a frame), each frame paired
    with the next."""
    frames = np.empty((size, FRAMES + 1, SIZE, SIZE), np.uint8)
    for i in range(size):
        texture = periodic_texture(np, rng, SIZE)
        dy, dx = rng.integers(-3, 4, 2)
        for t in range(FRAMES + 1):
            frames[i, t] = np.roll(texture, (t * dy, t * dx), (0, 1))
    rgb = rng.integers(0, 256, (size, FRAMES, SIZE, SIZE, 3), dtype=np.uint8)
    return {"rgb": torch.from_numpy(rgb).to(dev), "gray": torch.from_numpy(frames[:, :-1, ..., None]).to(dev),
            "gray_next": torch.from_numpy(frames[:, 1:, ..., None]).to(dev)}


def served_against_eager(torch, what: str, eager_fn, serve, batches, size: int, launch_fn) -> dict:
    """Time the eager forward and the served artifact over `batches` (after
    a warm-up each), count the served calls' kernel launches (`launch_fn()`
    reads the counters, `launch_fn(reset=True)` zeroes them), and check the
    served probabilities within 1e-2 of eager with equal predictions."""
    eager_fn(batches[0]), serve(batches[0])  # warm-up: cuDNN plans, allocator
    eager, served = [], []
    eager_ms = host_ms(lambda: eager.extend(eager_fn(b) for b in batches), torch, 1, 1)[0]
    launch_fn(reset=True)
    served_ms = host_ms(lambda: served.extend(serve(b) for b in batches), torch, 1, 1)[0]
    launches = launch_fn()
    dprob = max((o["probs"] - e).abs().max().item() for o, e in zip(served, eager))
    same = all(torch.equal(o["preds"], e.sum(0).argmax(-1)) for o, e in zip(served, eager))
    n = len(batches) * size
    print(f"{what}: {n * 1e3 / served_ms:.2f} clips/s served vs {n * 1e3 / eager_ms:.2f} eager "
          f"({len(batches)} batches of B={size}); max |dprob| vs eager {dprob:.3g}; preds equal: {same}; "
          f"launches {launches}")
    check(dprob <= 1e-2, f"{what}: served probabilities differ from eager by {dprob}")
    check(same, f"{what}: served predictions differ from eager")
    return launches


SERVE_FORMS_BATCH = 4


def check_serving_forms(torch, np, dev) -> None:
    """The serving export of the other families and forms at full width:
    2 TwoStream members (bf16) exported with gray-pair inputs, their flow
    computed in the program by turbo Farnebäck, and a dynamic-int8 I3D,
    each saved, loaded and served against its eager forward at B=4."""
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.members import make_member_forward
    from crowded_scenes_ensemble_classification_tpu_torch.flow.farneback import TURBO_PARAMS
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import max_pool_3x3x3_same
    from crowded_scenes_ensemble_classification_tpu_torch.serving import export_ensemble, serving_batch_example

    size, members = SERVE_FORMS_BATCH, 2
    rng = np.random.default_rng(31)
    bundles = seeded_members(torch, "TWOSTREAM_I3D", members, 2100)
    batches = [gray_pair_batch(torch, np, rng, dev, size) for _ in range(STEPS)]
    flow_params = dict(TURBO_PARAMS)
    t0 = time.perf_counter()
    program = export_ensemble(bundles, serving_batch_example(bundles[0], size, flow_precomputed=False),
                              input_scale=INPUT_SCALE, flow_params=flow_params)
    export_s = time.perf_counter() - t0
    serve, _, size_mb = artifact(program, {"model_type": "TWOSTREAM_I3D"})
    print(f"TwoStream serving, {members} full-width members (bf16), gray pairs in, turbo Farnebäck in the program: "
          f"export {export_s:.1f} s, artifact {size_mb:.1f} MB")

    def pool_launches(reset=False):
        if reset:
            max_pool_3x3x3_same.launches = 0
        return {"max_pool_3x3x3_same": max_pool_3x3x3_same.launches}

    eager = make_member_forward([b.module for b in bundles], (SIZE, SIZE), input_scale=INPUT_SCALE,
                                flow_params=flow_params)
    launches = served_against_eager(torch, "TwoStream served (gray pairs)", eager, serve, batches, size,
                                    pool_launches)
    check(launches["max_pool_3x3x3_same"] == 18 * members * STEPS,
          "TwoStream: not 18 max-pool launches a member a batch from the loaded program")
    del bundles, program, serve, eager, batches
    torch.cuda.empty_cache()

    (bundle,) = seeded_members(torch, "I3D", 1, 2200, quant=True)
    gen = torch.Generator(device=dev).manual_seed(32)
    batches = [{"rgb": torch.randint(0, 256, (size, FRAMES, SIZE, SIZE, 3), generator=gen, device=dev,
                                     dtype=torch.uint8)} for _ in range(STEPS)]
    t0 = time.perf_counter()
    program = export_ensemble([bundle], serving_batch_example(bundle, size), input_scale=INPUT_SCALE)
    export_s = time.perf_counter() - t0
    serve, _, size_mb = artifact(program, {"model_type": "I3D", "quant": "dynamic"})
    print(f"dynamic-int8 serving, one full-width I3D (bf16 compute, f32 weights): export {export_s:.1f} s, "
          f"artifact {size_mb:.1f} MB")

    def int8_counts(reset=False):
        if reset:
            zero_int8_launches()
        counts = int8_launches()
        return {k: counts[k] for k in ("int8_conv3d", "quantize_int8")}

    eager = make_member_forward([bundle.module], (SIZE, SIZE), input_scale=INPUT_SCALE)
    launches = served_against_eager(torch, "dynamic-int8 I3D served", eager, serve, batches, size, int8_counts)
    check(launches == {"int8_conv3d": I3D_CONVS * STEPS, "quantize_int8": I3D_CONVS * STEPS},
          f"the loaded dynamic-int8 program launched {launches}")


def relative_errors(a: dict, b: dict) -> dict:
    """‖a − b‖ / ‖b‖ for each key of b."""
    return {k: ((a[k].float() - b[k].float()).norm() / b[k].float().norm().clamp_min(1e-30)).item() for k in b}


def train_steps(step, state, batches, cw, torch):
    """Run step over batches → (state, [loss tensors], ms per step), timed on
    the host clock between two device synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for batch in batches:
        state, metrics = step(state, batch, cw)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    return state, losses, (time.perf_counter() - t0) * 1e3 / len(batches)


def check_training(torch, np, dev, kernels) -> None:
    """The resident training path at full width (20x224² clips from 256²
    uint8 staging, 11 classes, bf16 compute on f32 master weights): launch
    counts per step, a loss that falls on a repeated batch, fit over 2
    epochs with a best checkpoint, kernels against plain versions on one
    f32 step, and clips/s at B=16 and B=64."""
    import crowded_scenes_ensemble_classification_tpu_torch.models.i3d as i3d_mod
    import crowded_scenes_ensemble_classification_tpu_torch.ops.augment as augment_mod
    from crowded_scenes_ensemble_classification_tpu_torch.data.resident import ResidentClips
    from crowded_scenes_ensemble_classification_tpu_torch.models import build_model
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import (
        max_pool_3x3x3_reference,
        max_pool_3x3x3_same,
        max_pool_3x3x3_same_backward,
    )
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.noise import salt_pepper, salt_pepper_plain
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.stem_conv import stem_conv_7x7x7_s2
    from crowded_scenes_ensemble_classification_tpu_torch.train import (
        TrainState,
        evaluate_model,
        fit,
        make_optimizer,
        make_resident_train_step,
        restore_best,
        save_best,
    )

    rng = np.random.default_rng(9)
    cw = torch.ones(CLASSES, device=dev)

    def clips(n: int, batch: int = BATCH, **kw) -> ResidentClips:
        rgb = rng.integers(0, 256, (n, FRAMES, STAGING, STAGING, 3), dtype=np.uint8)
        return ResidentClips({"rgb": rgb}, rng.integers(0, CLASSES, n), batch, **kw)

    def trainable(seed: int, dtype=torch.bfloat16):
        return build_model("I3D", dtype=dtype, generator=torch.Generator().manual_seed(seed), trainable=True)

    def counters():
        return {"max_pool_3x3x3_same": max_pool_3x3x3_same.launches,
                "max_pool_3x3x3_same_backward": max_pool_3x3x3_same_backward.launches,
                "salt_pepper": salt_pepper.launches, "stem_conv_7x7x7_s2": stem_conv_7x7x7_s2.launches}

    # 1. The main training path: 3 augmented steps, launches counted.
    bundle, train_set, val_set = trainable(10), clips(3 * BATCH), clips(BATCH, shuffle=False)
    tx = make_optimizer("I3D", 0.003)
    step = make_resident_train_step(bundle, tx, (SIZE, SIZE), augment=True, input_scale=INPUT_SCALE)
    batches = list(train_set.batches(0))
    state = TrainState.create(bundle.module, tx, seed=0)
    state, _, _ = train_steps(step, state, batches[:1], cw, torch)  # warm-up: cuDNN plans, allocator
    max_pool_3x3x3_same.launches = max_pool_3x3x3_same_backward.launches = 0
    salt_pepper.launches = stem_conv_7x7x7_s2.launches = 0
    state, losses, ms = train_steps(step, state, batches, cw, torch)
    launches = counters()
    n = len(batches)
    print(f"training path: {n} resident steps, B={BATCH}, bf16 on f32 master weights, augment on: "
          f"{ms:.2f} ms/step; losses {[round(float(x), 4) for x in losses]}; launches {launches}")
    check(all(math.isfinite(float(x)) for x in losses), "non-finite training loss")
    check(launches == {"max_pool_3x3x3_same": 9 * n, "max_pool_3x3x3_same_backward": 9 * n, "salt_pepper": n,
                       "stem_conv_7x7x7_s2": 0}, f"training launch counts {launches}")
    for k in kernels:
        k["launches_train"] = launches[k["name"]]
        if k["name"] == "max_pool_3x3x3_same_backward":
            k["launches"] = launches[k["name"]]

    # 2. fit: 2 epochs over the resident sets, best checkpoint, reload.
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = fit(bundle, train_set, val_set, epochs=2, augment=True, input_scale=INPUT_SCALE, checkpoint_dir=tmp)
        fit_s = time.perf_counter() - t0
        hist = out["history"]
        print(f"fit: 2 epochs of {n} steps in {fit_s:.1f} s; history {hist}")
        check(len(hist["val_loss"]) == 2 and all(math.isfinite(x) for v in hist.values() for x in v),
              "fit history is short or not finite")
        twin = trainable(11)
        twin.module.load_state_dict(restore_best(tmp))
        best = evaluate_model(twin, val_set, (twin.clip.height, twin.clip.width), input_scale=INPUT_SCALE)["loss"]
        check(abs(best - out["best_val_loss"]) <= 1e-3 * abs(out["best_val_loss"]),
              f"the best checkpoint evaluates to {best}, not {out['best_val_loss']}")
        save_best(tmp, bundle.module.state_dict())
        back, now = restore_best(tmp), bundle.module.state_dict()
        check(back.keys() == now.keys() and all(torch.equal(back[k], now[k].cpu()) for k in now),
              "restore_best did not give back what save_best wrote")
    print(f"best checkpoint reloaded: val loss {best:.6f} (fit's best {out['best_val_loss']:.6f}); "
          "save_best/restore_best round trip equal")
    # 3. One batch again and again: the loss falls.
    still = make_resident_train_step(bundle, tx, (SIZE, SIZE), augment=False, input_scale=INPUT_SCALE)
    state, repeated, _ = train_steps(still, state, batches[:1] * 11, cw, torch)
    first, last = float(repeated[0]), float(repeated[-1])
    print(f"one batch repeated: loss {first:.4f} at the first step, {last:.4f} after 10 steps")
    check(last < first, f"the loss did not fall on a repeated batch: {first} -> {last}")

    del bundle, twin, state, step, still, out, train_set, val_set, batches
    torch.cuda.empty_cache()

    # 4. One f32 step through the kernels against the same step through the
    # plain versions (cuDNN deterministic, TF32 off), from equal weights.
    small = clips(4, batch=4)
    batch = next(small.batches(0))
    torch.backends.cudnn.deterministic = True
    runs = []
    for plain in (False, True):
        b = trainable(12, torch.float32)
        ftx = make_optimizer("I3D", 0.003)
        fstep = make_resident_train_step(b, ftx, (SIZE, SIZE), augment=True, input_scale=INPUT_SCALE)
        fstate = TrainState.create(b.module, ftx, seed=1)
        before = counters()
        if plain:
            with mock.patch.object(i3d_mod, "max_pool_3x3x3_same", max_pool_3x3x3_reference), \
                    mock.patch.object(augment_mod, "salt_pepper", salt_pepper_plain):
                fstep(fstate, batch, cw)
            check(counters() == before, "the plain run launched a kernel")
        else:
            fstep(fstate, batch, cw)
        runs.append(({n_: p.grad.detach().clone() for n_, p in b.module.named_parameters() if p.requires_grad},
                     {n_: p.detach().clone() for n_, p in b.module.named_parameters()}))
        del b, fstate, fstep
    torch.backends.cudnn.deterministic = False
    grad_err = max(relative_errors(runs[0][0], runs[1][0]).values())
    param_err = max(relative_errors(runs[0][1], runs[1][1]).values())
    print(f"one f32 step, B=4, kernels vs plain versions: max relative error {grad_err:.3g} over the "
          f"{len(runs[0][0])} gradients, {param_err:.3g} over the updated params")
    check(grad_err <= 1e-4 and param_err <= 1e-4, f"kernel and plain train steps differ: {grad_err}, {param_err}")
    del runs, small
    torch.cuda.empty_cache()

    # 5. Throughput at B=16 and B=64: 3 repeats of 5 steps after 2 warm-up steps.
    for batch_size in (BATCH, 64):
        b = trainable(13)
        btx = make_optimizer("I3D", 0.003)
        bstep = make_resident_train_step(b, btx, (SIZE, SIZE), augment=True, input_scale=INPUT_SCALE)
        data = clips(batch_size, batch=batch_size)
        steps = [next(data.batches(e)) for e in range(5)]
        bstate = TrainState.create(b.module, btx)
        torch.cuda.reset_peak_memory_stats()
        bstate, _, _ = train_steps(bstep, bstate, steps[:2], cw, torch)
        times = []
        for _ in range(3):
            bstate, _, ms = train_steps(bstep, bstate, steps, cw, torch)
            times.append(ms)
        mean = sum(times) / len(times)
        print(f"train B={batch_size}: ms/step {[round(t, 3) for t in times]} (mean {mean:.3f}, spread "
              f"{min(times):.3f}-{max(times):.3f}); clips/s {batch_size * 1e3 / mean:.2f} "
              f"({batch_size * 1e3 / max(times):.2f}-{batch_size * 1e3 / min(times):.2f}); peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
        del b, bstate, bstep, data, steps
        torch.cuda.empty_cache()


def check_stem_backward(torch, dev) -> None:
    """The kernel stem's weight gradient in train mode (bf16 compute, f32
    master weight, BatchNorm on batch statistics) against the canonical
    ConvBN's on the same weights and clips, B=2 at 20x224²: relative error
    within 2e-2 (bf16 rounding of the two forward convs)."""
    from crowded_scenes_ensemble_classification_tpu_torch.models.common import ConvBN, PallasStemConvBN, to_ncdhw

    gen = torch.Generator().manual_seed(14)
    kernel_stem = PallasStemConvBN(3, STEM_FEATURES, generator=gen).to(dev).train()
    canonical = ConvBN(3, STEM_FEATURES, (7, 7, 7), (2, 2, 2)).to(dev).train()
    canonical.load_state_dict(kernel_stem.state_dict())
    x = to_ncdhw(torch.randn(2, FRAMES, SIZE, SIZE, 3, generator=gen).to(dev, torch.bfloat16))
    r = torch.randn(2, STEM_FEATURES, FRAMES // 2, SIZE // 2, SIZE // 2, generator=gen).to(dev)
    grads = []
    for stem in (kernel_stem, canonical):
        (stem(x).float() * r).sum().backward()
        grads.append(stem.conv.weight.grad)
    err = relative_errors({"w": grads[0]}, {"w": grads[1]})["w"]
    print(f"stem backward, B=2 bf16 train mode: kernel stem vs canonical ConvBN weight gradient, relative "
          f"error {err:.3g} (|grad| max {grads[1].abs().max().item():.3g})")
    check(grads[1].abs().max().item() > 0 and err <= 2e-2, f"kernel-stem weight gradient differs: {err}")


ZOO_BATCH = {"R3D_101": 4, "R3D_152": 4}  # B=16 for the other families
HETERO_FAMILIES = ("I3D", "TWOSTREAM_I3D", "C3D", "R3D_18")  # JAX bench.py:546-549, in its order
HETERO_BATCHES = (BATCH, 64, 48, 32)  # B=16, then the JAX bench's BENCH_HETERO_BATCH (bench.py:540) or less
HETERO_STEPS, HETERO_REPEATS = 5, 3
FLOW_PAIRS, FLOW_REPEATS, FLOW_CALLS = 76, 3, 3  # JAX bench.py:89 (76 pairs of 224²), :369 (3 calls)
EPE_CEILING = 0.05  # px, translation: JAX tests/test_flow_motions.py:88
TWOSTREAM_BATCHES = (BATCH, 48, 32)  # B=16, then the JAX bench's TWOSTREAM_BATCH (bench.py:95) or less
EVAL_FOLDS = 2


def seeded_members(torch, model_type: str, count: int, seed: int, dtype=None, **kw) -> list:
    """`count` full-width members of `model_type` from `build_model`, on the
    card, each drawn there from a CUDA generator of its own seed (seed,
    seed + 1, ...), with BN statistics spread."""
    from crowded_scenes_ensemble_classification_tpu_torch.models import build_model

    out = []
    for i in range(count):
        gen = torch.Generator(device="cuda").manual_seed(seed + i)
        bundle = build_model(model_type, dtype=dtype or torch.bfloat16, generator=gen, **kw)
        spread_batchnorm(bundle.module, gen)
        out.append(bundle)
    return out


def seeded_clips(torch, dev, shape, seed: int):
    """Integer-valued 0-255 float32 clips on the card from a seed."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 256, shape, generator=gen, device=dev, dtype=torch.uint8).float()


def check_probs(torch, probs, shape, what: str) -> None:
    check(tuple(probs.shape) == tuple(shape), f"{what}: shape {tuple(probs.shape)}, not {shape}")
    check(bool(torch.isfinite(probs).all()), f"{what}: non-finite probabilities")
    check(bool(((probs.float().sum(-1) - 1.0).abs() <= 1e-2).all()), f"{what}: probabilities do not sum to 1")


def check_zoo(torch, dev) -> None:
    """Every model family at full width: a bf16 forward timed, and for C3D
    and R3D-18 an f32 forward on the card against the CPU."""
    from crowded_scenes_ensemble_classification_tpu_torch.core.config import MODEL_TYPES
    from crowded_scenes_ensemble_classification_tpu_torch.models import predict_proba

    for i, model_type in enumerate(MODEL_TYPES):
        (bundle,) = seeded_members(torch, model_type, 1, 200 + 10 * i)
        b = ZOO_BATCH.get(model_type, BATCH)
        batch = {k: seeded_clips(torch, dev, (b,) + shape, 300 + i) * INPUT_SCALE
                 for k, shape in (("rgb", bundle.clip.rgb_shape), ("flow", bundle.clip.flow_shape))
                 if k == "rgb" or bundle.two_stream}
        params = sum(p.numel() for p in bundle.module.parameters())
        torch.cuda.reset_peak_memory_stats()
        probs = predict_proba(bundle, batch)
        check_probs(torch, probs, (b, CLASSES), model_type)
        ms = cuda_ms(lambda: predict_proba(bundle, batch), iters=5, warmup=1, queue_ahead=False)
        print(f"zoo {model_type}: {params / 1e6:.2f} M params, bf16 B={b} {tuple(batch['rgb'].shape[1:])}"
              f"{' + flow' if bundle.two_stream else ''}: {ms:.3f} ms per batch, {b * 1e3 / ms:.2f} clips/s, "
              f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; max |p - 1/{CLASSES}| "
              f"{(probs - 1 / CLASSES).abs().max().item():.3g}")
        del bundle, batch, probs
        if model_type in ("C3D", "R3D_18"):
            (f32,) = seeded_members(torch, model_type, 1, 200 + 10 * i, dtype=torch.float32)
            x = seeded_clips(torch, dev, (2,) + f32.clip.rgb_shape, 400 + i) * INPUT_SCALE
            with torch.inference_mode():
                card = f32.module(x).cpu()
                cpu = f32.module.cpu()(x.cpu())
            rel = ((card - cpu).norm() / cpu.norm()).item()
            print(f"zoo {model_type} f32 B=2: card vs CPU logits relative error {rel:.3g} "
                  f"(max |logit| {cpu.abs().max().item():.3g}, std over classes {cpu.std(-1).mean().item():.3g})")
            check(cpu.std(-1).min().item() > 0 and rel <= 1e-3, f"{model_type} card logits differ from the CPU's: {rel}")
            del f32, x
        torch.cuda.empty_cache()


def hetero_families(torch) -> dict:
    """4 full-width bf16 members of each family of the JAX bench's
    heterogeneous ensemble, I3D and TwoStream in their prestaged form."""
    return {
        mt: [b.module for b in seeded_members(torch, mt, MEMBERS, 1000 + 100 * j,
                                              **({"stem_prestaged": True} if mt in ("I3D", "TWOSTREAM_I3D") else {}))]
        for j, mt in enumerate(HETERO_FAMILIES)
    }


def hetero_inputs(torch, dev, families, sizes, computed_flow: bool):
    """Seeded rgb, and precomputed flow unless `computed_flow`, at the first
    batch size in `sizes` whose two warm-up steps fit on the card (a
    smaller one is tried only after an out-of-memory error, and said so)
    → (size, rgb, flow or None)."""
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.pipeline import hetero_ensemble_step

    for size in sizes:
        try:
            rgb = seeded_clips(torch, dev, (size, FRAMES, SIZE, SIZE, 3), 500 + size)
            flow = None if computed_flow else seeded_clips(torch, dev, (size, FRAMES, SIZE, SIZE, 2), 600 + size)
            torch.cuda.reset_peak_memory_stats()
            for _ in range(2):  # warm-up: cuDNN plans, allocator
                hetero_ensemble_step(families, rgb, flow)
            return size, rgb, flow
        except torch.cuda.OutOfMemoryError:
            print(f"hetero B={size} does not fit on the card")
            rgb = flow = None
            torch.cuda.empty_cache()
    raise RuntimeError(f"chip_smoke check failed: no hetero batch of {sizes} fits")


def host_ms(fn, torch, repeats: int, calls: int) -> list:
    """Host milliseconds per call of fn, `repeats` times over `calls` calls,
    each run between two device synchronisations."""
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / calls)
    del out
    return times


def spread(times, size: int) -> str:
    mean = sum(times) / len(times)
    return (f"ms/step {[round(t, 3) for t in times]} (mean {mean:.3f}, spread {min(times):.3f}-{max(times):.3f}); "
            f"clips/s {size * 1e3 / mean:.2f} ({size * 1e3 / max(times):.2f}-{size * 1e3 / min(times):.2f})")


def check_hetero(torch, dev, families, kernels, computed: bool) -> None:
    """The heterogeneous step at B=16 and at the JAX bench's B=64 (or the
    largest of 48 and 32 that fits), on precomputed flow (1 repeat of 5
    steps) or with the flow computed on the card (`computed`: 3 repeats of
    5 steps, and the flow's own time a step): launches, peak memory."""
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.pipeline import clip_flow, hetero_ensemble_step
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import max_pool_3x3x3_same

    m = sum(len(v) for v in families.values())
    per_step = 9 * (len(families["I3D"]) + 2 * len(families["TWOSTREAM_I3D"]))
    k = next(k for k in kernels if k["name"] == "max_pool_3x3x3_same")
    for sizes in (HETERO_BATCHES[:1], HETERO_BATCHES[1:]):
        size, rgb, flow = hetero_inputs(torch, dev, families, sizes, computed)
        max_pool_3x3x3_same.launches = 0
        outs = []
        repeats = HETERO_REPEATS if computed else 1  # the precomputed form: one repeat, to keep the time
        times = host_ms(lambda: outs.append(hetero_ensemble_step(families, rgb, flow)), torch,
                        repeats, HETERO_STEPS)
        launches = max_pool_3x3x3_same.launches
        peak = torch.cuda.max_memory_allocated() / 1e9
        steps = HETERO_STEPS * repeats
        for probs, preds in outs[-HETERO_STEPS:]:
            check_probs(torch, probs, (m, size, CLASSES), f"hetero B={size}")
            check(torch.equal(preds, probs.sum(0).argmax(-1)), "hetero fused predictions are not the SUM argmax")
        check(launches == per_step * steps, f"hetero max-pool launches {launches}, not {per_step} a step")
        flow_note = "precomputed flow"
        if computed:
            with torch.inference_mode():
                flow_times = host_ms(lambda: clip_flow(rgb), torch, HETERO_REPEATS, 1)
            flow_note = (f"flow on the card: turbo Farnebäck alone {[round(t, 3) for t in flow_times]} ms a step "
                         f"({size * FRAMES} pairs, {size * FRAMES * 1e3 / min(flow_times):.1f} fields/s at best)")
        print(f"hetero step, {m} members ({', '.join(f'{len(v)} {k_}' for k_, v in families.items())}), bf16, "
              f"{flow_note}, B={size}{'' if size == sizes[0] else f' (B={sizes[0]} does not fit)'}: "
              f"{spread(times, size)}; max-pool launches {launches} in {steps} steps ({launches // steps} a step); "
              f"peak memory {peak:.2f} GB")
        if size == BATCH:
            k["launches_hetero_computed_flow" if computed else "launches_hetero"] = launches
            k["launches"] += launches
        del rgb, flow, outs
        torch.cuda.empty_cache()


def bench_flow_pairs(np, n: int, size: int):
    """The JAX bench's flow pairs (bench.py:343-356): a sinusoidal scene with
    ±3 noise, and the scene moved by (1, 2) with fresh noise."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    base = 128 + 60 * np.sin(xx / 17.0) + 50 * np.cos(yy / 23.0)
    prevs = np.stack([base + rng.integers(-3, 4, (size, size)) for _ in range(n)])
    currs = np.stack([np.roll(base, (1, 2), (0, 1)) + rng.integers(-3, 4, (size, size)) for _ in range(n)])
    return prevs.astype(np.float32), currs.astype(np.float32)


def periodic_texture(np, rng, size: int, sigma: float = 2.0):
    """A size² 0-255 texture periodic in both axes: seeded noise blurred by
    a Gaussian of `sigma` px through the FFT, stretched to a std of 45."""
    f = np.fft.fftfreq(size)
    gain = np.exp(-2.0 * (np.pi * sigma) ** 2 * (f[:, None] ** 2 + f[None, :] ** 2))
    base = np.real(np.fft.ifft2(np.fft.fft2(rng.random((size, size))) * gain))
    return np.clip((base - base.mean()) / base.std() * 45.0 + 128.0, 0.0, 255.0)


def flow_schedule_bound(h: int, w: int, levels=5, iterations=5, fine_iterations=None, fine_levels=1, **_):
    """(bytes, FLOP) a Farnebäck pair needs at least, from its pyramid's level
    sizes, if every pass kept its intermediates on chip: per level, the two
    frames read once and each level image written (pyramid), the first
    frame's fit (read 1 plane, write 5), and per iteration the warp (read
    the frame and the flow's 2 planes, write 1), the warped frame's fit
    (read 1, write 5) and the update (read 10 planes and the flow, write
    the flow): 24 float32 planes an iteration.  FLOP per pixel: the fit
    150 (30 + 60 taps, 5 × 6 multiply-adds), the update about 265 (220 in
    the 11-tap box), the separable warp about 30."""
    sizes = [(h, w)]
    for _ in range(1, levels):
        hh, ww = sizes[-1]
        if min(hh, ww) // 2 < 16:
            break
        sizes.append((-(-hh // 2), -(-ww // 2)))
    n_fine = min(fine_levels, len(sizes) - 1)
    planes = flops = 0.0
    for lvl, (hh, ww) in enumerate(sizes):
        px = hh * ww
        iters = fine_iterations if (lvl < n_fine and fine_iterations) else iterations
        planes += px * (2 + 6 + 24 * iters)
        flops += px * (150 + 445 * iters + (20 * 2 * 4 if lvl else 0))
    return planes * 4, flops


def check_flow(torch, np, dev) -> None:
    """Farnebäck (full and turbo) on the JAX bench's 76 pairs: fields/s with
    the spread, card against CPU, EPE; TV-L1 card against CPU."""
    from crowded_scenes_ensemble_classification_tpu_torch.flow.farneback import TURBO_PARAMS, farneback_flow_batch
    from crowded_scenes_ensemble_classification_tpu_torch.flow.tvl1 import tvl1_flow_pair

    prevs, currs = bench_flow_pairs(np, FLOW_PAIRS, SIZE)
    p, c = torch.from_numpy(prevs).to(dev), torch.from_numpy(currs).to(dev)
    rng = np.random.default_rng(4)
    tex = np.stack([periodic_texture(np, rng, SIZE) for _ in range(2)]).astype(np.float32)
    tex_p, tex_c = torch.from_numpy(tex).to(dev), torch.from_numpy(np.roll(tex, (1, 2), (1, 2))).to(dev)
    shift = torch.tensor([2.0, 1.0], device=dev)

    def epe(flow):
        return (flow[:, 16:-16, 16:-16] - shift).norm(dim=-1).mean().item()

    for name, kw in (("full (fast_warp)", dict(fast_warp=True)), ("turbo", dict(TURBO_PARAMS))):
        run = lambda: farneback_flow_batch(p, c, **kw)  # noqa: E731
        with torch.inference_mode():
            out = run()  # warm-up: allocator
            torch.cuda.reset_peak_memory_stats()
            times = host_ms(run, torch, FLOW_REPEATS, FLOW_CALLS)
            peak = torch.cuda.max_memory_allocated() / 1e9
            rates = [FLOW_PAIRS * 1e3 / t for t in times]
            cpu = farneback_flow_batch(p[:2].cpu(), c[:2].cpu(), **kw)
            err = (out[:2].cpu() - cpu).abs().max().item()
            tex_epe = epe(farneback_flow_batch(tex_p, tex_c, **kw))
        nbytes, flops = flow_schedule_bound(SIZE, SIZE, **kw)
        level_ms = bound(FLOW_PAIRS * nbytes, FLOW_PAIRS * flops, F32_FLOPS)
        io_ms = bound(FLOW_PAIRS * SIZE * SIZE * 4 * 4, FLOW_PAIRS * flops, F32_FLOPS)
        print(f"flow Farnebäck {name}, {FLOW_PAIRS} pairs of {SIZE}², one batch: ms a call "
              f"{[round(t, 3) for t in times]}; fields/s {[round(r, 1) for r in rates]} (mean "
              f"{sum(rates) / len(rates):.1f}, spread {min(rates):.1f}-{max(rates):.1f}); peak memory {peak:.2f} GB; "
              f"level-plane bound {level_ms[0]:.4f} ms ({level_ms[1]}, {FLOW_PAIRS * nbytes / 1e9:.3f} GB, "
              f"{FLOW_PAIRS * flops / 1e9:.2f} GFLOP), input-output bound {io_ms[0]:.4f} ms ({io_ms[1]}); "
              f"card vs CPU (2 pairs) max |d| {err:.3g} px; EPE {epe(out):.4f} px on the bench's sinusoids, "
              f"{tex_epe:.4f} px on textured pairs")
        check(bool(torch.isfinite(out).all()), f"non-finite {name} flow")
        check(err <= 1e-4, f"{name} flow on the card differs from the CPU by {err} px")
        check(tex_epe <= EPE_CEILING, f"{name} flow EPE {tex_epe} px on textured pairs")
        del out

    for dtype in (torch.float32, torch.bfloat16):
        t0 = time.perf_counter()
        got = tvl1_flow_pair(tex_p[0], tex_c[0], compute_dtype=dtype)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ref = tvl1_flow_pair(tex_p[0].cpu(), tex_c[0].cpu(), compute_dtype=dtype)
        d = (got.cpu() - ref).abs()
        print(f"flow TV-L1 one {SIZE}² pair, {dtype} duals: {ms:.1f} ms on the card (first call); card vs CPU "
              f"max |d| {d.max().item():.3g}, mean {d.mean().item():.3g} px; EPE {epe(got[None]):.4f} px")
        if dtype == torch.float32:
            check(d.max().item() <= 1e-3, f"TV-L1 f32 on the card differs from the CPU by {d.max().item()} px")
        else:
            check(d.mean().item() <= 0.05, f"TV-L1 bf16 duals on the card differ from the CPU by {d.mean().item()} px")


def moving_texture_rows(np, n: int):
    """(n, FRAMES·STAGING²·3/2) u8 I420 rows: each clip a periodic texture
    panned by its own seeded step (±3 px a frame in y and x), chroma from
    two more textures moved with it."""
    rng = np.random.default_rng(13)
    half = STAGING // 2
    rows = np.empty((n, FRAMES, STAGING * 3 // 2, STAGING), np.uint8)
    for i in range(n):
        y, u, v = (periodic_texture(np, rng, STAGING) for _ in range(3))
        dy, dx = rng.integers(-3, 4, 2)
        for t in range(FRAMES):
            rows[i, t, :STAGING] = np.roll(y, (t * dy, t * dx), (0, 1))
            for j, plane in enumerate((u, v)):
                chroma = np.roll(plane, (t * dy, t * dx), (0, 1))[::2, ::2] * 0.3 + 90.0
                rows[i, t, STAGING + j * half // 2: STAGING + (j + 1) * half // 2] = chroma.reshape(half // 2, STAGING)
    return rows.reshape(n, -1)


def check_twostream(torch, np, dev, kernels) -> None:
    """The resident TwoStream pipeline at B=16 and the bench's B=48 (or 32):
    3 repeats of 5 steps, launch counts, probabilities; then noise gates
    off, kernels against plain versions on the card."""
    import crowded_scenes_ensemble_classification_tpu_torch.models.i3d as i3d_mod
    import crowded_scenes_ensemble_classification_tpu_torch.ops.augment as augment_mod
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.pipeline import (
        AUGMENT_P,
        twostream_ensemble_step,
        twostream_step_from_decisions,
    )
    from crowded_scenes_ensemble_classification_tpu_torch.ops.augment import draw_decisions
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import (
        max_pool_3x3x3_reference,
        max_pool_3x3x3_same,
    )
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.noise import salt_pepper, salt_pepper_plain

    members = [b.module for b in seeded_members(torch, "TWOSTREAM_I3D", MEMBERS, 1500, stem_prestaged=True)]
    resident = torch.from_numpy(moving_texture_rows(np, TWOSTREAM_BATCHES[1])).to(dev)
    out_hw = (SIZE, SIZE)
    maxpool_k = next(k for k in kernels if k["name"] == "max_pool_3x3x3_same")
    noise_k = next(k for k in kernels if k["name"] == "salt_pepper")
    for sizes in (TWOSTREAM_BATCHES[:1], TWOSTREAM_BATCHES[1:]):
        for size in sizes:
            gen = torch.Generator().manual_seed(size)
            step = lambda i: twostream_ensemble_step(  # noqa: E731
                members, resident, i, gen, batch_size=size, frames=FRAMES, staging=STAGING, out_hw=out_hw)
            try:
                torch.cuda.reset_peak_memory_stats()
                for i in range(2):  # warm-up: cuDNN plans, allocator
                    step(i)
                break
            except torch.cuda.OutOfMemoryError:
                print(f"TwoStream pipeline B={size} does not fit on the card")
                torch.cuda.empty_cache()
        else:
            raise RuntimeError(f"chip_smoke check failed: no TwoStream batch of {sizes} fits")
        max_pool_3x3x3_same.launches = salt_pepper.launches = 0
        outs, counter = [], iter(range(10**6))
        times = host_ms(lambda: outs.append(step(next(counter))), torch, HETERO_REPEATS, HETERO_STEPS)
        launches = {"max_pool_3x3x3_same": max_pool_3x3x3_same.launches, "salt_pepper": salt_pepper.launches}
        steps = HETERO_REPEATS * HETERO_STEPS
        print(f"TwoStream pipeline, {MEMBERS} members, bf16, B={size}"
              f"{'' if size == sizes[0] else f' (B={sizes[0]} does not fit)'}: {spread(times, size)}; launches "
              f"{launches} in {steps} steps; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        check(launches == {"max_pool_3x3x3_same": 18 * MEMBERS * steps, "salt_pepper": steps},
              f"TwoStream pipeline launch counts {launches}")
        for probs, fused in outs[-HETERO_STEPS:]:
            check_probs(torch, probs, (MEMBERS, size, CLASSES), f"TwoStream pipeline B={size}")
            check(torch.equal(fused, probs.sum(0).argmax(-1)), "TwoStream fused predictions are not the SUM argmax")
        if size == BATCH:
            maxpool_k["launches_twostream"], noise_k["launches_twostream"] = launches.values()
            maxpool_k["launches"] += launches["max_pool_3x3x3_same"]
            noise_k["launches"] += launches["salt_pepper"]
        del outs
        torch.cuda.empty_cache()

    gen = torch.Generator().manual_seed(5)
    quiet = []
    for i in range(2):
        d = draw_decisions(gen, BATCH, (STAGING, STAGING), AUGMENT_P)
        off = torch.zeros_like(d.salt)
        quiet.append((resident[i * BATCH: (i + 1) * BATCH], dataclasses.replace(d, salt=off, pepper=off)))
    kernel = [twostream_step_from_decisions(members, r, d, FRAMES, STAGING, out_hw) for r, d in quiet]
    with mock.patch.object(i3d_mod, "max_pool_3x3x3_same", max_pool_3x3x3_reference), \
            mock.patch.object(augment_mod, "salt_pepper", salt_pepper_plain):
        before = (max_pool_3x3x3_same.launches, salt_pepper.launches)
        plain = [twostream_step_from_decisions(members, r, d, FRAMES, STAGING, out_hw) for r, d in quiet]
        check(before == (max_pool_3x3x3_same.launches, salt_pepper.launches), "plain run launched a kernel")
    dprob = max((a[0] - b[0]).abs().max().item() for a, b in zip(kernel, plain))
    same = all(torch.equal(a[1], b[1]) for a, b in zip(kernel, plain))
    print(f"TwoStream pipeline, noise gates off, 2 batches of B={BATCH}: kernels vs plain versions max |dprob| "
          f"{dprob:.3g}; fused argmax equal: {same}")
    check(same, "TwoStream fused argmax differs between kernel and plain runs")
    check(dprob <= 1e-2, f"TwoStream kernel and plain probabilities differ by {dprob}")


TRAIN_ZOO = (("C3D", 32), ("TWOSTREAM_I3D", 16), ("R3D_18", 32))  # JAX bench.py:640-654, at its batches
TRAIN_ZOO_STEPS, TRAIN_ZOO_REPEATS = 5, 3


def zoo_launches() -> dict:
    """The three training kernels' launch counters, by kernel name."""
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import (
        max_pool_3x3x3_same,
        max_pool_3x3x3_same_backward,
    )
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.noise import salt_pepper

    return {"max_pool_3x3x3_same": max_pool_3x3x3_same.launches,
            "max_pool_3x3x3_same_backward": max_pool_3x3x3_same_backward.launches,
            "salt_pepper": salt_pepper.launches}


def zero_zoo_launches() -> None:
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import (
        max_pool_3x3x3_same,
        max_pool_3x3x3_same_backward,
    )
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.noise import salt_pepper

    max_pool_3x3x3_same.launches = max_pool_3x3x3_same_backward.launches = salt_pepper.launches = 0


def zoo_resident(np, rng, bundle, rows: int, batch: int, **kw):
    """`rows` seeded uint8 clips at the bench's staging (the model size + 32,
    bench.py:664) as `ResidentClips` on the card; for TwoStream also the
    bench's f32 gray pairs: the clip's mean over channels paired with the
    next frame (bench.py:670-673)."""
    from crowded_scenes_ensemble_classification_tpu_torch.data.resident import ResidentClips

    c = bundle.clip
    rgb = rng.integers(0, 256, (rows, c.frames, c.height + 32, c.width + 32, 3), dtype=np.uint8)
    arrays = {"rgb": rgb}
    if bundle.two_stream:
        arrays["gray"] = rgb.mean(-1, keepdims=True, dtype=np.float32)
        arrays["gray_next"] = np.roll(arrays["gray"], -1, axis=1)
    return ResidentClips(arrays, rng.integers(0, CLASSES, rows), batch, **kw)


def train_zoo_family(torch, np, rng, model_type: str, batch: int, seed: int) -> dict:
    """One family's resident training at full width, augment on, bf16 on f32
    master weights drawn on the card: launches a step, finite losses, ms/step
    and clips/s over 3 repeats of 5 steps, peak memory, and a repeated batch
    whose loss falls.  Returns what the TwoStream checks reuse."""
    from crowded_scenes_ensemble_classification_tpu_torch.flow.farneback import flow_schedule_params
    from crowded_scenes_ensemble_classification_tpu_torch.models import build_model
    from crowded_scenes_ensemble_classification_tpu_torch.train import (
        TrainState,
        make_resident_eval_step,
        make_resident_train_step,
        train_policy,
    )

    bundle = build_model(model_type, dtype=torch.bfloat16, generator=torch.Generator(device="cuda").manual_seed(seed),
                         trainable=True)
    hw = (bundle.clip.height, bundle.clip.width)
    fp = flow_schedule_params("turbo") if bundle.two_stream else None  # the bench's schedule (bench.py:684-690)
    data = zoo_resident(np, rng, bundle, 2 * batch, batch)
    tx, l2 = train_policy(model_type)
    kw = dict(l2_weight=l2, input_scale=INPUT_SCALE, flow_params=fp)
    step = make_resident_train_step(bundle, tx, hw, augment=True, **kw)
    state = TrainState.create(bundle.module, tx, seed=seed)
    steps = [next(data.batches(e)) for e in range(TRAIN_ZOO_STEPS)]
    cw = torch.ones(CLASSES, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    state, _, _ = train_steps(step, state, steps[:2], cw, torch)  # warm-up: cuDNN plans, allocator
    times, losses = [], []
    for r in range(TRAIN_ZOO_REPEATS):
        if r == 0:
            zero_zoo_launches()
        state, run, ms = train_steps(step, state, steps, cw, torch)
        if r == 0:
            launches = zoo_launches()
        times.append(ms)
        losses += run
    peak = torch.cuda.max_memory_allocated() / 1e9
    per_step = {k: v // TRAIN_ZOO_STEPS for k, v in launches.items()}
    print(f"train {model_type} B={batch}, bf16 on f32 master weights, "
          f"augment on{', turbo flow from gray pairs in the step' if fp else ''}: {spread(times, batch)}; peak "
          f"memory {peak:.2f} GB; launches a step {per_step}")
    check(all(math.isfinite(float(x)) for x in losses), f"{model_type}: non-finite training loss")
    pool = 18 if bundle.two_stream else 0
    check(launches == {"max_pool_3x3x3_same": pool * TRAIN_ZOO_STEPS, "max_pool_3x3x3_same_backward":
                       pool * TRAIN_ZOO_STEPS, "salt_pepper": TRAIN_ZOO_STEPS},
          f"{model_type} train launch counts {launches} in {TRAIN_ZOO_STEPS} steps")

    # One batch again and again: the loss falls.  C3D's is read in eval mode
    # before and after, as its dropout draws new masks every step.
    still = make_resident_train_step(bundle, tx, hw, augment=False, **kw)
    loss_of = make_resident_eval_step(bundle, hw, input_scale=INPUT_SCALE, flow_params=fp)
    evaluated = lambda: (lambda o: (o["loss_sum"] / o["count"]).item())(loss_of(steps[0]))  # noqa: E731
    before = evaluated() if model_type == "C3D" else None
    state, repeated, _ = train_steps(still, state, steps[:1] * 11, cw, torch)
    first, last = (before, evaluated()) if model_type == "C3D" else (float(repeated[0]), float(repeated[-1]))
    print(f"train {model_type}: one batch repeated, loss {first:.4f} at the first step, {last:.4f} after 10 steps"
          f"{' (eval mode, no dropout)' if model_type == 'C3D' else ''}")
    check(last < first, f"{model_type}: the loss did not fall on a repeated batch: {first} -> {last}")
    return {"bundle": bundle, "data": data, "steps": steps, "tx": tx, "kw": kw, "state": state, "launches": launches,
            "ms": times}


def check_two_stream_training(torch, np, rng, fam: dict) -> None:
    """TwoStream only: the flow's own time a step, one step with
    `flow_from_augmented`, `fit` over 2 epochs with a best checkpoint, and
    one f32 step through the kernels against the plain versions."""
    import crowded_scenes_ensemble_classification_tpu_torch.models.i3d as i3d_mod
    import crowded_scenes_ensemble_classification_tpu_torch.ops.augment as augment_mod
    from crowded_scenes_ensemble_classification_tpu_torch.flow.farneback import gray_pair_flow
    from crowded_scenes_ensemble_classification_tpu_torch.models import build_model
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import max_pool_3x3x3_reference
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.noise import salt_pepper_plain
    from crowded_scenes_ensemble_classification_tpu_torch.train import (
        TrainState,
        evaluate_model,
        fit,
        make_resident_train_step,
        restore_best,
        train_policy,
    )

    bundle, data, kw = fam["bundle"], fam["data"], fam["kw"]
    hw = (bundle.clip.height, bundle.clip.width)
    cw = torch.ones(CLASSES, device="cuda")
    # The flow alone, on one step's gray pairs.
    idx = torch.as_tensor(fam["steps"][0]["indices"], device="cuda")
    gray, gray_next = (data.resident[k].index_select(0, idx) for k in ("gray", "gray_next"))
    with torch.no_grad():
        flow_times = host_ms(lambda: gray_pair_flow(gray, gray_next, hw, flow_params=kw["flow_params"]), torch,
                             TRAIN_ZOO_REPEATS, 1)
        flow_dev = cuda_ms(lambda: gray_pair_flow(gray, gray_next, hw, flow_params=kw["flow_params"]), iters=3,
                           warmup=1, queue_ahead=False)
    pairs = gray.shape[0] * gray.shape[1]
    print(f"train TWOSTREAM_I3D: the flow alone, {pairs} pairs of {tuple(gray.shape[2:4])} → {hw}, turbo: "
          f"{[round(t, 3) for t in flow_times]} ms a step on the host clock, {flow_dev:.3f} ms between CUDA events "
          f"(train step mean {sum(fam['ms']) / len(fam['ms']):.3f} ms)")
    del gray, gray_next

    # One step with the flow from the augmented gray pairs.
    tx = fam["tx"]
    aug = make_resident_train_step(bundle, tx, hw, augment=True, flow_from_augmented=True, **kw)
    zero_zoo_launches()
    state, losses, ms = train_steps(aug, fam["state"], fam["steps"][:1], cw, torch)
    launches = zoo_launches()
    print(f"train TWOSTREAM_I3D flow_from_augmented: loss {float(losses[0]):.4f}, {ms:.3f} ms, launches {launches}")
    check(math.isfinite(float(losses[0])) and launches == {"max_pool_3x3x3_same": 18,
                                                          "max_pool_3x3x3_same_backward": 18, "salt_pepper": 1},
          f"TwoStream flow_from_augmented step: loss {losses[0]}, launches {launches}")
    del aug, state, fam["state"]

    # fit: 2 epochs over the resident sets, a best checkpoint reloaded.
    val = zoo_resident(np, rng, bundle, BATCH, BATCH, shuffle=False)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = fit(bundle, data, val, epochs=2, augment=True, input_scale=INPUT_SCALE, checkpoint_dir=tmp,
                  flow_params=kw["flow_params"])
        hist = out["history"]
        print(f"train TWOSTREAM_I3D fit: 2 epochs of {len(data)} steps in {time.perf_counter() - t0:.1f} s; "
              f"history {hist}")
        check(len(hist["val_loss"]) == 2 and all(math.isfinite(x) for v in hist.values() for x in v),
              "TwoStream fit history is short or not finite")
        twin = build_model("TWOSTREAM_I3D", dtype=torch.bfloat16, trainable=True,
                           generator=torch.Generator(device="cuda").manual_seed(77))
        twin.module.load_state_dict(restore_best(tmp))
        best = evaluate_model(twin, val, hw, input_scale=INPUT_SCALE, flow_params=kw["flow_params"])["loss"]
    print(f"train TWOSTREAM_I3D: best checkpoint reloaded, val loss {best:.6f} (fit's best {out['best_val_loss']:.6f})")
    check(abs(best - out["best_val_loss"]) <= 1e-3 * abs(out["best_val_loss"]),
          f"the TwoStream best checkpoint evaluates to {best}, not {out['best_val_loss']}")
    del twin, out, val
    torch.cuda.empty_cache()

    # One f32 step through the kernels against the plain versions, B=4.
    small = zoo_resident(np, rng, bundle, 4, 4)
    batch = next(small.batches(0))
    torch.backends.cudnn.deterministic = True
    runs = []
    for plain in (False, True):
        b = build_model("TWOSTREAM_I3D", trainable=True, generator=torch.Generator(device="cuda").manual_seed(78))
        ftx, _ = train_policy("TWOSTREAM_I3D")
        fstep = make_resident_train_step(b, ftx, hw, augment=True, **kw)
        before = zoo_launches()
        if plain:
            with mock.patch.object(i3d_mod, "max_pool_3x3x3_same", max_pool_3x3x3_reference), \
                    mock.patch.object(augment_mod, "salt_pepper", salt_pepper_plain):
                fstep(TrainState.create(b.module, ftx, seed=1), batch, cw)
            check(zoo_launches() == before, "the plain TwoStream run launched a kernel")
        else:
            fstep(TrainState.create(b.module, ftx, seed=1), batch, cw)
        runs.append(({n: p.grad.detach().clone() for n, p in b.module.named_parameters() if p.requires_grad},
                     {n: p.detach().clone() for n, p in b.module.named_parameters()}))
        del b, fstep
    torch.backends.cudnn.deterministic = False
    grad_err = max(relative_errors(runs[0][0], runs[1][0]).values())
    param_err = max(relative_errors(runs[0][1], runs[1][1]).values())
    print(f"train TWOSTREAM_I3D one f32 step, B=4, kernels vs plain versions: max relative error {grad_err:.3g} "
          f"over the {len(runs[0][0])} gradients, {param_err:.3g} over the updated params")
    check(grad_err <= 1e-4 and param_err <= 1e-4, f"TwoStream kernel and plain steps differ: {grad_err}, {param_err}")


def check_multi_member(torch, np, rng) -> None:
    """M=2 full-width C3D members for 3 steps of `make_multi_member_train_step`
    (B=8, augment on, dropout on) against each member trained alone by
    `make_train_step` from the same weights and seed: params within 1e-6
    relative error (cuDNN deterministic)."""
    from crowded_scenes_ensemble_classification_tpu_torch.models import build_model
    from crowded_scenes_ensemble_classification_tpu_torch.train import (
        TrainState,
        make_multi_member_train_step,
        make_train_step,
        stack_states,
        train_policy,
    )

    m, b, steps = 2, 8, 3
    c = CLIP_SPECS["C3D"]
    hw = (c.height, c.width)
    batches = [{"rgb": rng.integers(0, 256, (m, b, c.frames, c.height + 32, c.width + 32, 3), dtype=np.uint8),
                "label": rng.integers(0, CLASSES, (m, b)), "valid": np.ones((m, b), bool)} for _ in range(steps)]
    cw = torch.ones(CLASSES, device="cuda")
    make = lambda i: build_model("C3D", dtype=torch.bfloat16, trainable=True,  # noqa: E731
                                 generator=torch.Generator(device="cuda").manual_seed(90 + i))
    torch.backends.cudnn.deterministic = True
    tx, _ = train_policy("C3D")
    members = [make(i) for i in range(m)]
    states = stack_states([TrainState.create(x.module, tx, seed=i) for i, x in enumerate(members)])
    multi = make_multi_member_train_step(members[0], tx, hw, augment=True, input_scale=INPUT_SCALE)
    t0 = time.perf_counter()
    for batch in batches:
        states, metrics = multi(states, batch, cw)
    torch.cuda.synchronize()
    multi_ms = (time.perf_counter() - t0) * 1e3 / steps
    errs = []
    for i in range(m):
        alone = make(i)
        atx, _ = train_policy("C3D")
        step = make_train_step(alone, atx, hw, augment=True, input_scale=INPUT_SCALE)
        state = TrainState.create(alone.module, atx, seed=i)
        for batch in batches:
            state, _ = step(state, {k: v[i] for k, v in batch.items()}, cw)
        ref = dict(alone.module.named_parameters())
        errs.append(max(relative_errors(dict(members[i].module.named_parameters()), ref).values()))
        del alone, state, step
    torch.backends.cudnn.deterministic = False
    print(f"multi-member: {m} C3D members, B={b}, {steps} steps ({multi_ms:.1f} ms a step for both), losses "
          f"{[round(x, 4) for x in metrics['loss'].tolist()]}; each member against itself trained alone: max "
          f"relative error {[f'{e:.3g}' for e in errs]}")
    check(tuple(metrics["loss"].shape) == (m,) and max(errs) <= 1e-6, f"multi-member differs from alone: {errs}")
    del members, states, multi
    torch.cuda.empty_cache()


def check_train_zoo(torch, np, dev, kernels) -> None:
    """Resident training of the rest of the zoo at full width (JAX
    bench.py:624-720): C3D at B=32, TwoStream-I3D at B=16 with turbo
    Farnebäck of resident gray pairs in the step, R3D-18 at B=32, then
    R3D-50 at B=8 for 2 steps; the TwoStream checks; the multi-member
    step.  Adds the launches of each family's first 5 timed steps to the
    kernels' record."""
    rng = np.random.default_rng(19)
    total = dict.fromkeys(("max_pool_3x3x3_same", "max_pool_3x3x3_same_backward", "salt_pepper"), 0)
    for i, (model_type, batch) in enumerate(TRAIN_ZOO):
        fam = train_zoo_family(torch, np, rng, model_type, batch, 100 + i)
        for k in total:
            total[k] += fam["launches"][k]
        if model_type == "TWOSTREAM_I3D":
            check_two_stream_training(torch, np, rng, fam)
        del fam
        torch.cuda.empty_cache()

    from crowded_scenes_ensemble_classification_tpu_torch.models import build_model
    from crowded_scenes_ensemble_classification_tpu_torch.train import (
        TrainState,
        make_resident_train_step,
        train_policy,
    )

    bundle = build_model("R3D_50", dtype=torch.bfloat16, trainable=True,
                         generator=torch.Generator(device="cuda").manual_seed(110))
    data = zoo_resident(np, rng, bundle, 8, 8)
    tx, l2 = train_policy("R3D_50")
    step = make_resident_train_step(bundle, tx, (bundle.clip.height, bundle.clip.width), augment=True, l2_weight=l2,
                                    input_scale=INPUT_SCALE)
    torch.cuda.reset_peak_memory_stats()
    zero_zoo_launches()
    _, losses, ms = train_steps(step, TrainState.create(bundle.module, tx), [next(data.batches(e)) for e in range(2)],
                                torch.ones(CLASSES, device=dev), torch)
    launches = zoo_launches()
    print(f"train R3D_50 B=8, bf16 on f32 master weights, 2 steps (cuDNN plans included): {ms:.1f} ms/step; losses "
          f"{[round(float(x), 4) for x in losses]}; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
          f"launches {launches}")
    check(all(math.isfinite(float(x)) for x in losses), "R3D_50: non-finite training loss")
    check(launches == {"max_pool_3x3x3_same": 0, "max_pool_3x3x3_same_backward": 0, "salt_pepper": 2},
          f"R3D_50 launch counts {launches}")
    del bundle, data, step
    torch.cuda.empty_cache()
    check_multi_member(torch, np, rng)
    for k in kernels:
        if k["name"] in total:
            k["launches_train_zoo"] = total[k["name"]]
            k["launches"] += total[k["name"]]


def same_evaluation(a, b, np) -> bool:
    """Two EnsembleResults equal field for field, weights and predictions
    exactly."""
    if (a.name, a.scheme, len(a.folds)) != (b.name, b.scheme, len(b.folds)):
        return False
    for x, y in zip(a.folds, b.folds):
        if (x.test_index, x.accuracy, x.member_accuracies) != (y.test_index, y.accuracy, y.member_accuracies):
            return False
        same_weights = x.weights == y.weights if isinstance(x.weights, str) else np.array_equal(x.weights, y.weights)
        if not (same_weights and np.array_equal(x.predictions, y.predictions)):
            return False
    return True


def check_evaluation(torch, np, dev, families) -> None:
    """member_probabilities of each family over two seeded batches → npz
    store → ProbProvider → evaluate_ensembles under every scheme, global
    and combination evaluation, on the card and on the CPU."""
    from crowded_scenes_ensemble_classification_tpu_torch.core.config import WEIGHTING_SCHEMES
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.evaluate import (
        combine_ensembles,
        evaluate_ensembles,
        global_evaluate_ensembles,
    )
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.members import member_probabilities
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.pipeline import (
        SMALL_CLIP_FRAMES,
        hetero_ensemble_step,
    )
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.probability_store import (
        load_probabilities,
        probability_cache_path,
        save_probabilities,
    )

    clips = [(seeded_clips(torch, dev, (BATCH, FRAMES, SIZE, SIZE, 3), 700 + t),
              seeded_clips(torch, dev, (BATCH, FRAMES, SIZE, SIZE, 2), 800 + t)) for t in range(EVAL_FOLDS)]
    labels = np.random.default_rng(12).integers(0, CLASSES, (EVAL_FOLDS, BATCH)).astype(np.int32)
    stepped = torch.cat([hetero_ensemble_step(families, rgb, flow)[0] for rgb, flow in clips], dim=1)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        stored = []
        for mt, members in families.items():
            if mt in ("I3D", "TWOSTREAM_I3D"):
                batches, hw = [{"rgb": rgb, "flow": flow} for rgb, flow in clips], (SIZE, SIZE)
            else:  # C3D and R3D take the step's 16×112² clips
                batches, hw = [{"rgb": rgb[:, :SMALL_CLIP_FRAMES, ::2, ::2]} for rgb, _ in clips], (SIZE // 2,) * 2
            probs = member_probabilities(members, batches, hw)  # (M, 2·B, C), pixels unscaled as in the step
            stored.append(probs)
            names = [f"{mt}_member{i}" for i in range(len(members))]
            for t in range(EVAL_FOLDS):  # fold t tests on batch t and selects weights on the other
                for subset, part in (("test", t), ("train_val", 1 - t)):
                    rows = slice(part * BATCH, (part + 1) * BATCH)
                    save_probabilities(probability_cache_path(tmp, mt, t, subset), probs[:, rows], labels[part], names)
        probs_s = time.perf_counter() - t0
        providers = {mt: (lambda t, subset, mt=mt: load_probabilities(probability_cache_path(tmp, mt, t, subset)))
                     for mt in families}
        back = np.concatenate([np.concatenate([providers[mt](t, "test")["probs"] for mt in families])
                               for t in range(EVAL_FOLDS)], axis=1)
        check(np.array_equal(back, np.concatenate(stored)), "the store did not give back what was saved")
        agrees, dfused = fused_argmax_agrees(stepped, torch.from_numpy(back).to(dev), torch)
        dprob = (stepped.cpu() - torch.from_numpy(back)).abs().max().item()
        print(f"store: {len(families)} families x {EVAL_FOLDS} batches of B={BATCH} through member_probabilities "
              f"in {probs_s:.1f} s; against hetero_ensemble_step on the same clips max |dprob| {dprob:.3g}, "
              f"max |dfused| {dfused:.3g}, fused argmax agrees: {agrees}")
        check(agrees and dprob <= 1e-2, "stored probabilities disagree with the heterogeneous step's")

        losses = lambda t: [0.8 + 0.1 * t, 1.2, 0.6, 0.95]  # noqa: E731
        for mt, provider in providers.items():
            line = []
            for scheme in WEIGHTING_SCHEMES:
                kw = dict(name=mt, min_val_losses_provider=losses, de_seed=0)
                t0 = time.perf_counter()
                card = evaluate_ensembles(provider, EVAL_FOLDS, scheme, device=dev, **kw)
                card_ms = (time.perf_counter() - t0) * 1e3
                cpu = evaluate_ensembles(provider, EVAL_FOLDS, scheme, device="cpu", **kw)
                check(same_evaluation(card, cpu, np), f"{mt} {scheme}: the card's evaluation differs from the CPU's")
                line.append(f"{scheme} {card.mean_accuracy:.4f} ({card_ms:.0f} ms)")
            print(f"evaluate {mt}, {EVAL_FOLDS} folds, card == CPU: " + "; ".join(line))
        card = global_evaluate_ensembles(providers, EVAL_FOLDS, device=dev)
        check(same_evaluation(card, global_evaluate_ensembles(providers, EVAL_FOLDS, device="cpu"), np),
              "the card's global evaluation differs from the CPU's")
        combos = combine_ensembles(providers, EVAL_FOLDS, device=dev)
        check(len(combos) == 2 ** len(families) - 1
              and combos == combine_ensembles(providers, EVAL_FOLDS, device="cpu"),
              "the card's combination search differs from the CPU's")
        print(f"global ensemble of {sum(len(v) for v in families.values())} members: mean accuracy "
              f"{card.mean_accuracy:.4f} (random labels: chance is {1 / CLASSES:.4f}); {len(combos)} subsets, "
              f"best {'+'.join(combos[0][0])} {combos[0][1]:.4f}; card == CPU")


INT8_BATCHES = (BATCH, 48, 32)  # B=16, then B=48 (32 if 48 does not fit)
INT8_STEPS, INT8_REPEATS = 5, 3
INT8_OPS = 1979e12  # H100 SXM data sheet, dense int8 per second
# A cold rotation of more launches than the device's launch queue holds
# (about 1,000) stalls the host: the rotation of the small Mixed_5* inputs
# stops at 512 launches (38 MB of the 50 MB L2 at the smallest, so partly
# warm; a split-K conv launches twice a call, so half as many copies).
INT8_COLD_COPIES = 512
I3D_CONVS = 3 + 9 * 6  # stem, Conv3d_2b, Conv3d_2c and six convs in each Mixed block
# (what, x NTHWC, F, kernel, strides, padding) beyond one I3D member's
# convs: C3D conv1 and the R3D-18 stem on C = 3 at 16×112², an R3D-18
# stage-1 3³/2 conv and its 1³/2 VALID projection, ragged cases (C = 24
# and 17, odd T/H/W, F = 13, a stride of (1, 2, 1)), and routes the
# member's convs do not take: the stem's 4C = 12 unpadded (4-byte copies;
# the models pad it to 16), C = 2 (byte gather) and a split K.
INT8_EXTRA_CASES = [
    ("C3D conv1", (2, 16, 112, 112, 3), 64, (3, 3, 3), (1, 1, 1), "SAME"),
    ("R3D-18 stem", (2, 16, 112, 112, 3), 64, (7, 7, 7), (2, 2, 2), "SAME"),
    ("R3D-18 3^3/2", (2, 4, 28, 28, 64), 128, (3, 3, 3), (2, 2, 2), "SAME"),
    ("R3D-18 1^3/2 projection", (2, 4, 28, 28, 64), 128, (1, 1, 1), (2, 2, 2), "VALID"),
    ("ragged C=24, odd T/H/W", (2, 5, 7, 9, 24), 40, (3, 3, 3), (1, 1, 1), "SAME"),
    ("ragged C=17, F=13", (1, 3, 5, 7, 17), 13, (3, 3, 3), (1, 2, 1), "SAME"),
    ("ragged C=3, F=13, odd extents", (1, 3, 5, 7, 3), 13, (3, 3, 3), (1, 1, 1), "SAME"),
    ("C=12 on 4-byte copies", (2, 10, 30, 30, 12), 64, (7, 4, 4), (2, 1, 1), ((2, 3), (0, 0), (0, 0))),
    ("C=2, byte gather", (2, 4, 10, 10, 2), 16, (3, 3, 3), (1, 1, 1), "SAME"),
    ("Mixed_5c 3^3 at B=16, split K", (16, 3, 7, 7, 192), 384, (3, 3, 3), (1, 1, 1), "SAME"),
]


def int8_launches() -> dict:
    """`zoo_launches()` with the stem's and the two int8 kernels' counters."""
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels import int8_conv, stem_conv

    return {**zoo_launches(), "stem_conv_7x7x7_s2": stem_conv.stem_conv_7x7x7_s2.launches,
            "int8_conv3d": int8_conv.int8_conv3d.launches, "quantize_int8": int8_conv.quantize_int8.launches}


def zero_int8_launches() -> None:
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels import int8_conv, stem_conv

    zero_zoo_launches()
    stem_conv.stem_conv_7x7x7_s2.launches = int8_conv.int8_conv3d.launches = int8_conv.quantize_int8.launches = 0


def captured_int8_calls(fn) -> tuple:
    """Run fn() with the models' int8 conv and quantize calls recorded:
    ([(x8, wp, scale, bias, kernel, strides, pads)], [(x, scalar, dynamic,
    channels)]), the i-th quantize pass making the i-th conv's x8."""
    import crowded_scenes_ensemble_classification_tpu_torch.models.common as common_mod

    convs, quants = [], []
    conv, quant = common_mod.int8_conv3d, common_mod.quantize_int8

    def conv_rec(*a):
        convs.append(a)
        return conv(*a)

    def quant_rec(x, scalar, dynamic=False, channels=None):  # an older checkout's quantize takes no channels
        quants.append((x, scalar, dynamic, channels))
        return quant(x, scalar, dynamic) if channels is None else quant(x, scalar, dynamic, channels)

    with mock.patch.object(common_mod, "int8_conv3d", conv_rec), mock.patch.object(common_mod, "quantize_int8",
                                                                                     quant_rec):
        fn()
    return convs, quants


def int8_plain(call, channels=None):
    """The plain version of a recorded int8 conv call, on its own tensors:
    the conv on x8's first `channels` (all by default; the quantize pass
    pads the stems' 12 to 16 with zeros)."""
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.int8_conv import (
        int8_conv3d_reference,
        unpack_int8_weights,
    )

    x8, wp, scale, bias, kernel, strides, pads = call
    c = x8.shape[-1] if channels is None else channels
    k8 = unpack_int8_weights(wp, scale.shape[0], kernel, c)
    return int8_conv3d_reference(x8[..., :c], k8, scale, bias, strides, pads)


def conv_channels(call, quant) -> int:
    """The channels of a recorded int8 conv's function: those of the
    quantize pass's input, which x8 may widen with zero channels."""
    x = quant[0]
    check(tuple(x.shape[:-1]) == tuple(call[0].shape[:-1]) and x.shape[-1] <= call[0].shape[-1],
          f"quantize pass {tuple(x.shape)} does not make the conv's x8 {tuple(call[0].shape)}")
    return x.shape[-1]


def int8_main_clips(torch, resident, seed: int, count: int) -> list:
    """`count` batches of the main path's clips (decode + augment of the
    resident rows, 0-255 f32), as `calibrate_members` takes them."""
    from crowded_scenes_ensemble_classification_tpu_torch.data.wire_format import i420_to_bgr_u8
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.pipeline import _resident_batch
    from crowded_scenes_ensemble_classification_tpu_torch.ops.augment import crowd11_augment_from_decisions

    gen = torch.Generator().manual_seed(seed)
    out = []
    for i in range(count):
        rows, d = _resident_batch(resident, i, gen, BATCH, STAGING)
        batch = i420_to_bgr_u8(rows, FRAMES, STAGING, STAGING)
        out.append({"rgb": crowd11_augment_from_decisions(batch, (SIZE, SIZE), d)})
    return out


# The kernel's earlier mma.sync design (128 x 64 tiles, one K step in
# flight, registers staging the loads) on the same 57 convs at B=16, cold,
# by kind (PERF.md section 6, NVIDIA H100 80GB HBM3, 700 W), printed beside
# this run's.
INT8_MMA_SYNC_MS = {"stem": 1.848, "3x3x3": 3.084, "1x1x1": 0.929, "all": 5.8609}


def int8_conv_kind(kernel) -> str:
    return "stem" if tuple(kernel) == (7, 4, 4) else "x".join(map(str, kernel))


def time_int8_convs(torch, convs, quants) -> dict:
    """Hold each recorded int8 conv call equal to its plain version and time
    it (kernel warm and cold, plain version, cuDNN's bf16 conv of the same
    shape, and for the 1³/1 convs `torch._int_mm` + the dequantize, checked
    equal), a line each with its route and tile; then the sums by kind
    (stem, 3x3x3, 1x1x1) beside the earlier mma.sync design.  Operations,
    bytes and the yardsticks are those of the conv's own channels
    (`conv_channels`), not of x8's zero channels.  Returns the sums over
    all convs, with `by_kind` and the largest difference `err`."""
    import torch.nn.functional as F

    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels import int8_conv as ic

    keys = ("warm", "cold", "plain", "bf16", "bytes", "ops", "mm", "mm_kernel")
    conv_tot, by_kind = {**dict.fromkeys(keys, 0.0), "err": 0.0}, {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for i, (call, quant) in enumerate(zip(convs, quants, strict=True)):
        x8, wp, scale, bias, kernel, strides, pads = call
        c, f = conv_channels(call, quant), scale.shape[0]
        got, ref = ic.int8_conv3d(*call), int8_plain(call, c)
        conv_tot["err"] = max(conv_tot["err"], (got - ref).abs().max().item())
        check(torch.equal(got, ref), f"int8 conv kernel != plain at the member's conv {i} at B={x8.shape[0]}: "
                                     f"x {tuple(x8.shape)}, kernel {kernel}, strides {strides}, pads {pads}")
        m = got.numel() // f
        k8 = ic.unpack_int8_weights(wp, f, kernel, c)
        ops = 2 * m * f * math.prod(kernel) * c
        nbytes = x8.numel() // x8.shape[-1] * c + k8.numel() + got.numel() * 4 + f * 4
        route = ic.int8_conv_route(x8, wp, f, kernel, strides, pads, sms)
        launches = 2 if route["splits"] > 1 else 1  # a split K adds the finish kernel
        warm = cuda_ms(lambda: ic.int8_conv3d(*call))
        cold = cuda_ms_cold(lambda x: ic.int8_conv3d(x, *call[1:]),
                            cold_inputs(x8)[:INT8_COLD_COPIES // launches])
        plain = cuda_ms(lambda: int8_plain(call, c), iters=2, warmup=1, queue_ahead=False)
        flat = [p for axis in reversed(pads) for p in axis]
        xb = F.pad(x8[..., :c].permute(0, 4, 1, 2, 3).to(torch.bfloat16), flat).contiguous(
            memory_format=torch.channels_last_3d)
        wb = k8.to(torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
        bf16 = cuda_ms(lambda: F.conv3d(xb, wb, stride=strides))
        line = (f"int8 conv {i:2d} x {tuple(x8.shape)}{'' if c == x8.shape[-1] else f' (its function on C={c})'} F={f} k{tuple(kernel)} s{tuple(strides)} "
                f"[{route['tile']} tile, split K {route['splits']}, A by {route['a_copy']}]: kernel warm {warm:.4f} ms, "
                f"cold {cold:.4f} ms ({ops / cold / 1e9:.1f} TOPS, {bound(nbytes, ops, INT8_OPS)[0] / cold:.1%} "
                f"of bound); plain {plain:.3f} ms; cuDNN bf16 conv (another function) {bf16:.4f} ms")
        kind = by_kind.setdefault(int8_conv_kind(kernel), dict.fromkeys(("n", *keys), 0.0))
        if tuple(kernel) == (1, 1, 1) and tuple(strides) == (1, 1, 1):
            x2, w2 = x8[..., :c].reshape(-1, c), k8.reshape(f, c).contiguous().t()  # (C, F) column-major
            mm = lambda: torch._int_mm(x2, w2).float() * scale  # noqa: E731
            check(torch.equal(mm().view(got.shape), got), f"torch._int_mm + dequantize != the kernel at conv {i}")
            mm_ms = cuda_ms(mm)
            for tot in (conv_tot, kind):
                tot["mm"] += mm_ms
                tot["mm_kernel"] += cold
            line += f"; torch._int_mm + dequantize {mm_ms:.4f} ms"
        print(line)
        for tot in (conv_tot, kind):
            for k, v in zip(("warm", "cold", "plain", "bf16", "bytes", "ops"), (warm, cold, plain, bf16, nbytes, ops)):
                tot[k] += v
        kind["n"] += 1
        del xb, wb, got, ref
    for name, t in sorted(by_kind.items()) + [("all", conv_tot)]:
        n = len(convs) if name == "all" else int(t["n"])
        b, by = bound(t["bytes"], t["ops"], INT8_OPS)
        mm = f", torch._int_mm + dequantize {t['mm']:.4f} ms" if t["mm"] else ""
        print(f"int8 conv by kind, {name} ({n} convs) at B={convs[0][0].shape[0]}: kernel cold {t['cold']:.4f} ms "
              f"({t['ops'] / t['cold'] / 1e9:.1f} TOPS, {b / t['cold']:.1%} of its {b:.4f} ms bound by {by}), warm "
              f"{t['warm']:.4f} ms; the mma.sync design {INT8_MMA_SYNC_MS[name]} ms; cuDNN bf16 {t['bf16']:.4f} ms{mm}; plain "
              f"{t['plain']:.3f} ms; {t['ops'] / 1e12:.3f} T int8 ops, {t['bytes'] / 1e9:.3f} GB")
    conv_tot["by_kind"] = by_kind
    return conv_tot


def check_int8_kernels(torch, dev, member, xs2, xs16) -> list:
    """The int8 kernels against their plain versions (`torch.equal`) at
    every conv of one I3D member at B=2 on the main path's clips, at
    INT8_EXTRA_CASES and on both quantize modes; then each of the member's
    convs (`time_int8_convs`) and quantize passes at B=16 timed beside its
    bound, its plain version and the library yardsticks.  Returns the two
    kernels' records."""
    from crowded_scenes_ensemble_classification_tpu_torch.models.common import conv_pads
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.int8_conv import (
        int8_conv3d,
        int8_conv3d_reference,
        pack_int8_weights,
        quantize_int8,
        quantize_int8_reference,
    )

    with torch.inference_mode():
        convs, quants = captured_int8_calls(lambda: member(xs2))
    check(len(convs) == I3D_CONVS and len(quants) == I3D_CONVS,
          f"one static I3D member made {len(convs)} int8 convs and {len(quants)} quantize passes, not {I3D_CONVS}")
    err = 0.0
    for i, (call, quant) in enumerate(zip(convs, quants, strict=True)):
        got, ref = int8_conv3d(*call), int8_plain(call, conv_channels(call, quant))
        err = max(err, (got - ref).abs().max().item())
        check(torch.equal(got, ref), f"int8 conv kernel != plain at the member's conv {i}: x {tuple(call[0].shape)}, "
                                     f"kernel {call[4]}, strides {call[5]}, pads {call[6]}")
    cins = sorted({c[0].shape[-1] for c in convs})
    gen = torch.Generator(device=dev).manual_seed(17)
    for what, shape, f, kernel, strides, padding in INT8_EXTRA_CASES:
        x8 = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int32).to(torch.int8)
        k8 = torch.randint(-127, 128, (f, shape[-1], *kernel), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8)
        scale, bias = torch.rand(f, generator=gen, device=dev) * 1e-3, torch.randn(f, generator=gen, device=dev)
        pads = conv_pads(shape[1:4], kernel, strides, padding)
        got = int8_conv3d(x8, pack_int8_weights(k8), scale, bias, kernel, strides, pads)
        check(torch.equal(got, int8_conv3d_reference(x8, k8, scale, bias, strides, pads)),
              f"int8 conv kernel != plain at {what}")
    for i, (x, scalar, dynamic, channels) in enumerate(quants):
        check(not dynamic and torch.equal(quantize_int8(x, scalar, False, channels),
                                          quantize_int8_reference(x, scalar, False, channels)),
              f"static quantize kernel != plain at the member's pass {i}")
        sx = x.abs().amax().float().clamp_min(1e-30) / 127.0
        check(torch.equal(quantize_int8(x, sx, True, channels), quantize_int8_reference(x, sx, True, channels)),
              f"dynamic quantize kernel != plain at the member's pass {i}")
    torch.cuda.synchronize()
    print(f"int8: the kernel == its plain version at all {len(convs)} convs of one static I3D member on B=2 main-path "
          f"clips (Cin {cins}) and {len(INT8_EXTRA_CASES)} more shapes "
          f"({'; '.join(c[0] for c in INT8_EXTRA_CASES)}); quantize == plain, static and dynamic, at its "
          f"{len(quants)} inputs")

    with torch.inference_mode():
        convs, quants = captured_int8_calls(lambda: member(xs16))
    conv_tot = time_int8_convs(torch, convs, quants)
    q_tot = dict.fromkeys(("warm", "cold", "plain", "bytes"), 0.0)
    for x, scalar, _, channels in quants:
        q_tot["warm"] += cuda_ms(lambda: quantize_int8(x, scalar, False, channels))
        q_tot["cold"] += cuda_ms_cold(lambda v: quantize_int8(v, scalar, False, channels), cold_inputs(x))
        q_tot["plain"] += cuda_ms(lambda: quantize_int8_reference(x, scalar, False, channels))
        q_tot["bytes"] += x.numel() * x.element_size() + x.numel() // x.shape[-1] * (channels or x.shape[-1])
    cb, cb_by = bound(conv_tot["bytes"], conv_tot["ops"], INT8_OPS)
    qb, qb_by = bound(q_tot["bytes"], 0.0, INT8_OPS)
    print(f"quantize, the member's {len(quants)} static passes at B={BATCH}: kernel cold {q_tot['cold']:.4f} ms "
          f"({qb / q_tot['cold']:.1%} of bound), warm {q_tot['warm']:.4f} ms; plain {q_tot['plain']:.4f} ms; bound "
          f"{qb:.4f} ms ({qb_by}, {q_tot['bytes'] / 1e9:.3f} GB)")
    return [
        {"name": "int8_conv3d", "route": "cuda", "source": f"{PORT}/csrc/int8_conv3d.cu",
         "replaces": "none (XLA's int8 conv_general_dilated in crowded_scenes_ensemble_classification_tpu/models/"
                     "common.py:111 and :176)",
         "launches": 0, "max_abs_err": max(err, conv_tot["err"]), "ms": conv_tot["cold"], "warm_ms": conv_tot["warm"],
         "plain_ms": conv_tot["plain"], "bound_ms": cb, "bound_by": cb_by, "library_ms": None,
         "int_mm_1x1_ms": conv_tot["mm"], "kernel_1x1_ms": conv_tot["mm_kernel"],
         "bf16_cudnn_ms": conv_tot["bf16"],
         "cold_ms_by_kind": {k: v["cold"] for k, v in sorted(conv_tot["by_kind"].items())}},
        {"name": "quantize_int8", "route": "cuda", "source": f"{PORT}/csrc/quantize_int8.cu",
         "replaces": "none (XLA's elementwise quantize in crowded_scenes_ensemble_classification_tpu/models/"
                     "common.py:196-199)",
         "launches": 0, "max_abs_err": 0.0, "ms": q_tot["cold"], "warm_ms": q_tot["warm"], "plain_ms": q_tot["plain"],
         "bound_ms": qb, "bound_by": qb_by, "library_ms": None},
    ]


def check_int8_export(torch, dev, bundle) -> None:
    """One baked static-int8 member at full width through the serving export
    (shared staging, B=2): exported, saved and loaded, its probabilities
    equal the eager `make_member_forward`'s exactly, and the loaded program
    launches one int8 conv and one quantize pass a conv."""
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.members import make_member_forward
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.int8_conv import int8_conv3d, quantize_int8
    from crowded_scenes_ensemble_classification_tpu_torch.serving import (
        export_ensemble,
        load_serving_artifact,
        save_serving_artifact,
        serving_batch_example,
    )

    gen = torch.Generator(device=dev).manual_seed(29)
    batch = {"rgb": torch.randint(0, 256, (2, FRAMES, SIZE, SIZE, 3), generator=gen, device=dev, dtype=torch.uint8)}
    eager = make_member_forward([bundle.module], (SIZE, SIZE), share_stem_staging=True)(batch)
    t0 = time.perf_counter()
    program = export_ensemble([bundle], serving_batch_example(bundle, 2), share_stem_staging=True)
    export_s = time.perf_counter() - t0
    ops = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    check({"csec.int8_conv3d.default", "csec.quantize_int8.default"} <= ops, "the static export calls no int8 op")
    with tempfile.TemporaryDirectory() as tmp:
        serve, _ = load_serving_artifact(save_serving_artifact(os.path.join(tmp, "int8.zip"), program, {}))
    before = (int8_conv3d.launches, quantize_int8.launches)
    out = serve(batch)
    torch.cuda.synchronize()
    launched = (int8_conv3d.launches - before[0], quantize_int8.launches - before[1])
    same = torch.equal(out["probs"], eager)
    print(f"int8 serving export: one baked static I3D member, full width, B=2, shared staging: export {export_s:.1f} s; "
          f"loaded artifact == eager make_member_forward: {same}; int8 conv / quantize launches {launched}")
    check(launched == (I3D_CONVS, I3D_CONVS), f"the loaded static program launched {launched}")
    check(same, "the loaded static-int8 artifact differs from the eager forward")


def oracle_i3d():
    """tests/oracle_i3d.py (numpy only) loaded by its path: the source of the
    reference-layout I3D layer dicts."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "oracle_i3d", os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "oracle_i3d.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


INT8_GATE = 0.05  # softmax drift of int8 from f32, JAX tests/test_quant.py:124, :257


def check_int8_gate(torch, np, dev) -> None:
    """The JAX int8 accuracy gate on the card (tests/test_quant.py:97-125,
    :222-258): the I3D of `random_i3d_h5_layers(seed=3)` (16 frames, 11
    classes) through weights_io and load_pretrained, on two raw 0-255
    batches (2, 16, 32, 32, 3) from default_rng(11); the dynamic I3D and the
    static one calibrated on the first batch within 0.05 of the f32 forward
    (TF32 off) in softmax, top-1 unchanged; the static one on the held-out
    batch finite, top-1 stable."""
    from crowded_scenes_ensemble_classification_tpu_torch.models.i3d import I3D
    from crowded_scenes_ensemble_classification_tpu_torch.models.pretrained import load_pretrained
    from crowded_scenes_ensemble_classification_tpu_torch.models.quantize import (
        calibrate,
        quantize_variables,
        set_quant_mode,
    )

    layers = oracle_i3d().random_i3d_h5_layers(seed=3, num_classes=CLASSES)
    rng = np.random.default_rng(11)
    x, held = (torch.from_numpy(rng.uniform(0, 255, (2, 16, 32, 32, 3)).astype(np.float32)).to(dev)
               for _ in range(2))
    models = {}
    for name, quant in (("f32", False), ("dynamic", True), ("static", "calib")):
        with torch.device(dev):
            models[name] = load_pretrained("I3D", I3D(CLASSES, frames=16, quant=quant).eval(), CLASSES, rgb_h5=layers)
    set_quant_mode(quantize_variables(calibrate(models["static"], [x])), "static")
    zero_int8_launches()
    with torch.inference_mode():
        probs = {name: [torch.softmax(m(b), -1) for b in (x, held)] for name, m in models.items()}
    launched = int8_launches()["int8_conv3d"]
    drift = {name: (probs[name][0] - probs["f32"][0]).abs().max().item() for name in ("dynamic", "static")}
    top1 = {name: torch.equal(probs[name][0].argmax(-1), probs["f32"][0].argmax(-1)) for name in drift}
    held_ok = bool(torch.isfinite(probs["static"][1]).all()) and torch.equal(
        probs["static"][1].argmax(-1), probs["f32"][1].argmax(-1))
    print(f"int8 accuracy gate (JAX tests/test_quant.py geometry, reference-layout I3D seed 3, raw 0-255 "
          f"(2,16,32,32,3), f32 TF32 off): max |dprob| from f32 dynamic {drift['dynamic']:.4g}, static "
          f"{drift['static']:.4g} (gate {INT8_GATE}); top-1 unchanged {top1}; static held-out batch finite and top-1 "
          f"stable: {held_ok}; {launched} int8 conv launches")
    check(launched == 4 * I3D_CONVS, f"the gate's int8 models launched {launched} int8 convs, not 4 x {I3D_CONVS}")
    for name, d in drift.items():
        check(d < INT8_GATE and top1[name], f"{name} int8 I3D drifts {d} from f32 (top-1 unchanged: {top1[name]})")
    check(held_ok, "the static int8 I3D's held-out batch is not finite or its top-1 moved")


def check_int8(torch, np, dev, kernels) -> None:
    """Static int8 inference on the card: calibrate 4 full-width I3D members
    on the main path's clips, hold the kernels to their plain versions and
    time them, run the int8 main path at B=16 and B=48, compare it with the
    bf16 main path, a small static I3D on the card with the CPU, and every
    family's static forward at full width."""
    import copy

    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.members import (
        calibrate_members,
        make_member_forward,
    )
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.pipeline import (
        AUGMENT_P,
        ensemble_step_from_decisions,
        resident_ensemble_step,
    )
    from crowded_scenes_ensemble_classification_tpu_torch.models import build_model
    from crowded_scenes_ensemble_classification_tpu_torch.models.common import s2d_stem_stage
    from crowded_scenes_ensemble_classification_tpu_torch.models.i3d import I3D
    from crowded_scenes_ensemble_classification_tpu_torch.models.pretrained import load_pretrained
    from crowded_scenes_ensemble_classification_tpu_torch.models.quantize import (
        calibrate,
        calibration_summary,
        quantize_variables,
        set_quant_mode,
    )
    from crowded_scenes_ensemble_classification_tpu_torch.ops.augment import draw_decisions

    check_int8_gate(torch, np, dev)
    ibytes = FRAMES * STAGING * STAGING * 3 // 2
    rows = np.random.default_rng(23).integers(0, 256, (2 * INT8_BATCHES[1], ibytes), dtype=np.uint8)
    resident = torch.from_numpy(rows).to(dev)
    bundles = seeded_members(torch, "I3D", MEMBERS, 1700, quant="calib", stem_prestaged=True)
    members = [b.module for b in bundles]
    oracle = oracle_i3d()
    for i, m in enumerate(members):  # reference-layout checkpoints, converted on the card's host without h5py
        layers = oracle.random_i3d_h5_layers(seed=3 + i, num_classes=CLASSES)
        layers.pop("predictions")  # the no-top form the Crowd-11 fine-tune loads: the 20-frame head stays seeded
        load_pretrained("I3D", m, CLASSES, rgb_h5=layers)
    print(f"int8 members: {MEMBERS} full-width I3Ds from reference-layout layer dicts (random_i3d_h5_layers seeds "
          f"3-{2 + MEMBERS}) through weights_io and load_pretrained, seeded heads")
    calib_clips = int8_main_clips(torch, resident, 24, 2)
    t0 = time.perf_counter()
    calibrate_members(members, calib_clips, (SIZE, SIZE), num_batches=2)
    torch.cuda.synchronize()
    scales = calibration_summary(members[0])
    print(f"int8 calibration: {MEMBERS} members (bf16 compute, f32 weights) on 2 batches of B={BATCH} main-path clips "
          f"in {time.perf_counter() - t0:.2f} s; member 0: {len(scales)} sites, act_absmax "
          f"{min(scales.values()):.4g}..{max(scales.values()):.4g}")
    check(len(scales) == I3D_CONVS and all(v > 0 for v in scales.values()), "calibration left a site at 0")

    check_int8_export(torch, dev, bundles[0])
    xs16 = s2d_stem_stage(calib_clips[0]["rgb"].to(torch.bfloat16))
    kernels.extend(check_int8_kernels(torch, dev, members[0], xs16[:2].contiguous(), xs16))
    conv_k, quant_k = kernels[-2], kernels[-1]
    maxpool_k = next(k for k in kernels if k["name"] == "max_pool_3x3x3_same")
    noise_k = next(k for k in kernels if k["name"] == "salt_pepper")
    del xs16

    per_step = {"int8_conv3d": I3D_CONVS * MEMBERS, "quantize_int8": I3D_CONVS * MEMBERS,
                "max_pool_3x3x3_same": 9 * MEMBERS, "max_pool_3x3x3_same_backward": 0, "salt_pepper": 1,
                "stem_conv_7x7x7_s2": 0}
    for sizes in (INT8_BATCHES[:1], INT8_BATCHES[1:]):
        for size in sizes:
            gen = torch.Generator().manual_seed(size)
            step = lambda i: resident_ensemble_step(  # noqa: E731
                members, resident, i, gen, batch_size=size, frames=FRAMES, staging=STAGING, out_hw=(SIZE, SIZE))
            try:
                torch.cuda.reset_peak_memory_stats()
                for i in range(2):  # warm-up: allocator, cuDNN plans of the BN
                    step(i)
                break
            except torch.cuda.OutOfMemoryError:
                print(f"int8 main path B={size} does not fit on the card")
                torch.cuda.empty_cache()
        else:
            raise RuntimeError(f"chip_smoke check failed: no int8 main-path batch of {sizes} fits")
        zero_int8_launches()
        outs, counter = [], iter(range(10**6))
        times = host_ms(lambda: outs.append(step(next(counter))), torch, INT8_REPEATS, INT8_STEPS)
        launches = int8_launches()
        steps = INT8_REPEATS * INT8_STEPS
        print(f"int8 main path, {MEMBERS} static members, B={size}"
              f"{'' if size == sizes[0] else f' (B={sizes[0]} does not fit)'}: {spread(times, size)}; launches "
              f"{launches} in {steps} steps ({ {k: v / steps for k, v in launches.items()} } a step); peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        check(launches == {k: v * steps for k, v in per_step.items()}, f"int8 main path launch counts {launches}")
        for probs, fused in outs[-INT8_STEPS:]:
            check_probs(torch, probs, (MEMBERS, size, CLASSES), f"int8 main path B={size}")
            check(torch.equal(fused, probs.sum(0).argmax(-1)), "int8 fused predictions are not the SUM argmax")
        if size == BATCH:
            conv_k["launches"], quant_k["launches"] = launches["int8_conv3d"], launches["quantize_int8"]
            maxpool_k["launches_int8"], noise_k["launches_int8"] = (launches["max_pool_3x3x3_same"],
                                                                    launches["salt_pepper"])
            maxpool_k["launches"] += launches["max_pool_3x3x3_same"]
            noise_k["launches"] += launches["salt_pepper"]
        del outs
        torch.cuda.empty_cache()

    # the bf16 main path on the same weights, rows and decisions
    plain = [build_model("I3D", dtype=torch.bfloat16, stem_prestaged=True).module for _ in members]
    for p, m in zip(plain, members):
        p.load_state_dict({k: v for k, v in m.state_dict().items() if not k.endswith(("act_absmax", ".k8", ".sw"))})
    gen = torch.Generator().manual_seed(5)
    dprob, agrees, dfused = 0.0, True, 0.0
    for i in range(2):
        d = draw_decisions(gen, BATCH, (STAGING, STAGING), AUGMENT_P)
        r = resident[i * BATCH: (i + 1) * BATCH]
        p8, _ = ensemble_step_from_decisions(members, r, d, FRAMES, STAGING, (SIZE, SIZE))
        pb, _ = ensemble_step_from_decisions(plain, r, d, FRAMES, STAGING, (SIZE, SIZE))
        dprob = max(dprob, (p8 - pb).abs().max().item())
        ok, df = fused_argmax_agrees(pb, p8, torch)
        agrees, dfused = agrees and ok, max(dfused, df)
    print(f"int8 against bf16 main path, 2 batches of B={BATCH}, same reference-layout weights, rows and decisions "
          f"(printed, not gated; 0.982 on random-init members, PR 10): max |dprob| {dprob:.3g}, max |dfused| "
          f"{dfused:.3g}; fused argmax agrees where the top-2 gap exceeds twice that: {agrees}")
    check(agrees, "the int8 main path's fused argmax differs from the bf16 path's beyond the fused difference")
    del plain, members, bundles, resident
    torch.cuda.empty_cache()

    # one small static I3D (f32, TF32 off): the kernels on the card against the plain versions on the CPU
    gen = torch.Generator().manual_seed(7)
    cpu = I3D(CLASSES, frames=16, generator=gen, quant="calib").eval()
    spread_batchnorm(cpu, gen)
    x = torch.randn(2, 16, 32, 32, 3, generator=gen) * 50.0
    set_quant_mode(quantize_variables(calibrate(cpu, [x])), "static")
    card = copy.deepcopy(cpu).to(dev)
    zero_int8_launches()
    with torch.inference_mode():
        ref = torch.softmax(cpu(x), -1)
        got = torch.softmax(card(x.to(dev)), -1).cpu()
    err = (got - ref).abs().max().item()
    print(f"small static I3D (2,16,32,32,3) f32: card (kernels, {int8_launches()['int8_conv3d']} int8 conv launches) "
          f"vs CPU (plain versions) max |dprob| {err:.3g}")
    check(int8_launches()["int8_conv3d"] == I3D_CONVS, "the small static I3D did not launch one int8 conv a conv")
    check(err <= 1e-3, f"card static I3D disagrees with the CPU's: {err}")

    # every family's static forward at full width, each calibrated on one batch
    for i, (model_type, kw) in enumerate((("C3D", {}), ("R3D_18", {}), ("TWOSTREAM_I3D", {"stem_prestaged": True}),
                                          ("I3D", {"stem_prestaged": True}))):
        (bundle,) = seeded_members(torch, model_type, 1, 1800 + 10 * i, quant="calib", **kw)
        batch = {k: seeded_clips(torch, dev, (BATCH,) + shape, 1900 + i)
                 for k, shape in (("rgb", bundle.clip.rgb_shape), ("flow", bundle.clip.flow_shape))
                 if k == "rgb" or bundle.two_stream}
        hw, share = (bundle.clip.height, bundle.clip.width), bool(kw)
        (member,) = calibrate_members([bundle.module], [batch], hw, num_batches=1, input_scale=INPUT_SCALE)
        forward = make_member_forward([member], hw, share_stem_staging=share, input_scale=INPUT_SCALE)
        torch.cuda.reset_peak_memory_stats()
        zero_int8_launches()
        probs = forward(batch)
        convs = int8_launches()["int8_conv3d"]
        check_probs(torch, probs, (1, BATCH, CLASSES), f"static {model_type}")
        ms = cuda_ms(lambda: forward(batch), iters=5, warmup=1, queue_ahead=False)
        print(f"static int8 {model_type} full width, B={BATCH}: {convs} int8 convs a forward, {ms:.3f} ms per batch, "
              f"{BATCH * 1e3 / ms:.2f} clips/s, peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
              f"max |p - 1/{CLASSES}| {(probs - 1 / CLASSES).abs().max().item():.3g}")
        check(convs > 0, f"static {model_type} launched no int8 conv")
        del bundle, member, forward, batch, probs
        torch.cuda.empty_cache()


INGEST_SCENES, INGEST_CLIPS, INGEST_FRAMES, INGEST_HW, INGEST_FOLDS = 55, 3, 48, (240, 320), 5
TWOSTREAM_INGEST_BATCH = 8


def device_busy_ms(prof) -> float:
    """Milliseconds of the union of the card's kernel, memcpy and memset
    intervals in a profile."""
    from torch.autograd import DeviceType

    total, end = 0.0, float("-inf")
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == DeviceType.CUDA):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def batches_equal(a: list, b: list, np) -> bool:
    return len(a) == len(b) and all(
        x.keys() == y.keys() and all(np.asarray(x[k]).dtype == np.asarray(y[k]).dtype
                                     and np.array_equal(x[k], y[k]) for k in x)
        for x, y in zip(a, b))


def ingest_dataset(data, root: str):
    """The Crowd-11-shaped synthetic dataset under root/crowd (55 scenes × 3
    mp4 clips, 11 classes, 48 frames at 240×320), written unless it is
    there: (its table, the seconds writing took, 0.0 if none)."""
    crowd = os.path.join(root, "crowd")
    if os.path.isdir(os.path.join(crowd, "rgb")):
        return data.build_clip_table(crowd), 0.0
    t0 = time.perf_counter()
    table = data.generate_synthetic_dataset(
        crowd, num_scenes=INGEST_SCENES, clips_per_scene=INGEST_CLIPS, num_classes=CLASSES,
        num_frames=INGEST_FRAMES, hw=INGEST_HW, seed=0, write_flow=False, as_videos=True)
    return table, time.perf_counter() - t0


def check_ingest(torch, np, dev, kernels, tmp: str) -> None:
    """Data ingest on the card's host: a Crowd-11-shaped synthetic dataset
    written as mp4 under `tmp` (phase 22 reads it too), the clip table, 5
    scene-stratified folds and the split matrix, cv2 decode through
    `BatchPipeline` with prefetch into `member_probabilities` and `fit`, the
    native clip cache, `ResidentClips.from_pipeline`, and TwoStream members
    on gray pairs."""
    import cv2

    from crowded_scenes_ensemble_classification_tpu_torch import data
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.members import member_probabilities
    from crowded_scenes_ensemble_classification_tpu_torch.flow.farneback import TURBO_PARAMS
    from crowded_scenes_ensemble_classification_tpu_torch.models import build_model
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import (
        max_pool_3x3x3_same,
        max_pool_3x3x3_same_backward,
    )
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.noise import salt_pepper
    from crowded_scenes_ensemble_classification_tpu_torch.train import fit

    print(f"ingest host: os.cpu_count() {os.cpu_count()}, cv2 {cv2.__version__} ({cv2.getNumThreads()} threads)")
    spec = data.SampleSpec(FRAMES, (STAGING, STAGING))
    probs_of = lambda members, batches, **kw: member_probabilities(  # noqa: E731
        members, batches, (SIZE, SIZE), input_scale=INPUT_SCALE, **kw)

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    table, write_s = ingest_dataset(data, tmp)
    paths = list(table["rgbclips_path"])
    check(len(paths) == INGEST_SCENES * INGEST_CLIPS and all(p.endswith(".mp4") for p in paths),
          "the synthetic dataset is not mp4 videos")
    check(all(data.video_frame_count(p) == INGEST_FRAMES for p in paths[::16]), "video_frame_count")

    clips = data.build_clip_table(os.path.join(tmp, "crowd"))
    folder, scenes = data.generate_folds(clips, os.path.join(tmp, "folds"), INGEST_FOLDS)
    pairs = data.write_split_matrix(data.load_fold_csvs(folder, INGEST_FOLDS), os.path.join(tmp, "splits"))
    split = {name: data.ClipTable.read_csv(os.path.join(pairs[0][2], f"{name}.csv"))
             for name in ("train", "val", "test")}
    sizes = {k: len(v) for k, v in split.items()}
    check(len(clips) == len(table) and data.verify_folds_disjoint(scenes) and len(pairs) == 20
          and pairs[0][:2] == (0, 1) and sum(sizes.values()) == len(clips), f"folds and splits {sizes}")
    check(sizes["test"] % BATCH != 0, "the test split fills its last batch")
    print(f"dataset: {len(table)} mp4 clips ({INGEST_SCENES} scenes × {INGEST_CLIPS}, {CLASSES} classes, "
          f"{INGEST_FRAMES} frames at {INGEST_HW[0]}×{INGEST_HW[1]}) written in {write_s:.1f} s; "
          f"{INGEST_FOLDS} folds of scenes {[len(f) for f in scenes]}, split (test 0, val 1) sizes {sizes}")

    source = data.ClipSource(spec)
    t0 = time.perf_counter()
    for i in range(8):
        source(split["test"].row(i))
    print(f"host decode, one thread: {(time.perf_counter() - t0) / 8 * 1e3:.1f} ms a clip "
          f"({INGEST_FRAMES} frames → {FRAMES} at {STAGING}²)")

    # 1. Probabilities of 4 I3D members over the test split.
    members = [b.module for b in seeded_members(torch, "I3D", MEMBERS, 40, stem_prestaged=True)]
    test_pipe = data.BatchPipeline(split["test"], spec, BATCH, shuffle=False, num_workers=8)
    held, held_s = synced(lambda: list(test_pipe.batches(0)))
    probs_of(members, held[:1])  # warm-up: cuDNN plans, allocator
    max_pool_3x3x3_same.launches = 0
    probs, decode_s = synced(lambda: probs_of(members, test_pipe))
    launches = max_pool_3x3x3_same.launches
    n, nb = sizes["test"], len(test_pipe)
    check(launches == 9 * MEMBERS * nb, f"max-pool launches {launches}, not {9 * MEMBERS * nb}")
    check_probs(torch, torch.from_numpy(probs), (MEMBERS, n, CLASSES), "decode-inclusive probabilities")
    held_probs, memory_s = synced(lambda: probs_of(members, held))
    check(np.array_equal(probs, held_probs), "decode-inclusive probabilities differ from the in-memory ones")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, profiled_s = synced(lambda: probs_of(members, test_pipe))
    busy_ms = device_busy_ms(prof)
    check(0 < busy_ms <= profiled_s * 1e3, f"device busy {busy_ms} ms of a {profiled_s * 1e3} ms pass")
    print(f"member_probabilities, {MEMBERS} I3D members, bf16, {nb} batches of B={BATCH} ({n} clips, the last "
          f"batch {n - (nb - 1) * BATCH} valid): decode-inclusive (prefetch, 8 decode threads) {n / decode_s:.2f} "
          f"clips/s; from memory {n / memory_s:.2f} clips/s (torch.equal); host decode alone {n / held_s:.2f} "
          f"clips/s ({nb * BATCH / held_s:.2f} decodes/s, the padded rows decoded too); card busy {busy_ms:.1f} ms of a profiled decode-inclusive pass of {profiled_s * 1e3:.1f} ms "
          f"({busy_ms / (profiled_s * 1e3):.3f}), of the unprofiled {decode_s * 1e3:.1f} ms "
          f"({busy_ms / (decode_s * 1e3):.3f}); max-pool launches {launches} (9 a member a batch)")

    # 2. The native clip cache: populate, then batches and probabilities from it.
    cache_pipe = data.BatchPipeline(split["test"], spec, BATCH, shuffle=False, num_workers=8,
                                    cache_file=os.path.join(tmp, "cache", "test.ccache"))
    t0 = time.perf_counter()
    cache_pipe.populate()
    populate_s = time.perf_counter() - t0
    check(cache_pipe.cached and all(batches_equal(list(cache_pipe.batches(e)), held, np) for e in (0, 1)),
          "clip-cache batches differ from the decoded ones")
    cached_probs, cache_s = synced(lambda: probs_of(members, cache_pipe))
    check(np.array_equal(cached_probs, probs), "probabilities from the clip cache differ from the decoded ones")
    shard_mb = os.path.getsize(cache_pipe.source.cache_file) / 1e6
    print(f"clip cache: populated with {n} clips in {populate_s:.2f} s ({shard_mb:.1f} MB); "
          f"epochs 0 and 1 by native read_batch bit-equal to decode; member_probabilities from the cache "
          f"{n / cache_s:.2f} clips/s, equal to the decode route's")
    maxpool_k = next(k for k in kernels if k["name"] == "max_pool_3x3x3_same")
    maxpool_k["launches_ingest_probs"] = launches
    maxpool_k["launches"] += launches
    del members, held, cache_pipe
    torch.cuda.empty_cache()

    # 3. fit of one trainable I3D over the train split, validated on the val split.
    gen = torch.Generator(device=dev).manual_seed(45)
    bundle = build_model("I3D", dtype=torch.bfloat16, device=dev, generator=gen, trainable=True)
    train_pipe = data.BatchPipeline(split["train"], spec, BATCH, seed=0, num_workers=8)
    val_pipe = data.BatchPipeline(split["val"], spec, BATCH, shuffle=False, num_workers=8)
    max_pool_3x3x3_same.launches = max_pool_3x3x3_same_backward.launches = salt_pepper.launches = 0
    out, fit_s = synced(lambda: fit(bundle, train_pipe, val_pipe, epochs=1, augment=True, balanced_classes=True,
                                    input_scale=INPUT_SCALE))
    steps, vb = len(train_pipe), len(val_pipe)
    launches = {"max_pool_3x3x3_same": max_pool_3x3x3_same.launches,
                "max_pool_3x3x3_same_backward": max_pool_3x3x3_same_backward.launches,
                "salt_pepper": salt_pepper.launches}
    hist = out["history"]
    print(f"fit over BatchPipelines: 1 epoch, {steps} train steps of B={BATCH} ({sizes['train']} clips, "
          f"augment, balanced classes) and {vb} val batches ({sizes['val']} clips) in {fit_s:.2f} s: "
          f"{(sizes['train'] + sizes['val']) / fit_s:.2f} clips/s decode-inclusive; history {hist}; "
          f"launches {launches}")
    check(all(math.isfinite(x) for v in hist.values() for x in v) and len(hist["val_loss"]) == 1,
          "fit over the pipeline: short or non-finite history")
    check(launches == {"max_pool_3x3x3_same": 9 * (steps + vb), "max_pool_3x3x3_same_backward": 9 * steps,
                       "salt_pepper": steps}, f"fit launch counts {launches}")
    for k in kernels:
        if k["name"] in launches:
            k["launches_ingest_fit"] = launches[k["name"]]
            k["launches"] += launches[k["name"]]
    del bundle, out
    torch.cuda.empty_cache()

    res = data.ResidentClips.from_pipeline(train_pipe, device=dev)
    rows = res.resident["rgb"].cpu().numpy()
    same = all(np.array_equal(rows[b["index"][b["valid"]]], b["rgb"][b["valid"]])
               for b in data.BatchPipeline(split["train"], spec, BATCH, shuffle=False, num_workers=8).batches(0))
    check(same and res.n == sizes["train"] and res.resident["rgb"].device.type == dev.type,
          "ResidentClips.from_pipeline rows differ from the pipeline's decoded samples")
    print(f"ResidentClips.from_pipeline: {res.n} train clips on the card ({res.nbytes / 1e9:.2f} GB), rows "
          "bit-equal to the pipeline's decoded batches")
    del res, rows
    torch.cuda.empty_cache()

    # 4. TwoStream members on gray pairs staged in the same decode pass.
    ts_members = [b.module for b in seeded_members(torch, "TWOSTREAM_I3D", 2, 50, stem_prestaged=True)]
    ts_spec = data.SampleSpec(FRAMES, (STAGING, STAGING), two_stream=True, flow_precomputed=False)
    ts_pipe = data.BatchPipeline(split["test"], ts_spec, TWOSTREAM_INGEST_BATCH, shuffle=False, num_workers=8)
    ts_held = list(ts_pipe.batches(0))
    check(sorted(ts_held[0]) == ["gray", "gray_next", "index", "label", "rgb", "valid"], "TwoStream batch keys")
    flow_params = dict(TURBO_PARAMS)
    probs_of(ts_members, ts_held[:1], flow_params=flow_params)  # warm-up
    max_pool_3x3x3_same.launches = 0
    ts_probs, ts_s = synced(lambda: probs_of(ts_members, ts_pipe, flow_params=flow_params))
    launches, nb = max_pool_3x3x3_same.launches, len(ts_pipe)
    check(launches == 18 * 2 * nb, f"TwoStream max-pool launches {launches}, not {18 * 2 * nb}")
    check_probs(torch, torch.from_numpy(ts_probs), (2, n, CLASSES), "TwoStream decode-inclusive probabilities")
    check(np.array_equal(ts_probs, probs_of(ts_members, ts_held, flow_params=flow_params)),
          "TwoStream decode-inclusive probabilities differ from the in-memory ones")
    print(f"TwoStream: 2 members, gray pairs staged by one decode pass, turbo Farnebäck on the card, {nb} batches "
          f"of B={TWOSTREAM_INGEST_BATCH}: {n / ts_s:.2f} clips/s decode-inclusive, equal to the in-memory "
          f"batches; max-pool launches {launches} (18 a member a batch)")
    maxpool_k["launches_ingest_twostream"] = launches
    maxpool_k["launches"] += launches
    del ts_members, ts_held
    torch.cuda.empty_cache()


EXPERIMENT_BATCH, EXPERIMENT_FOLDS = 8, 3


def offline_decisions(torch, clip, seed: int):
    """The offline policy's decisions of one decoded clip, as
    `augment_offline.augment_clip` draws them (a CPU generator seeded by
    `seed`)."""
    from crowded_scenes_ensemble_classification_tpu_torch.data.augment_offline import OFFLINE_AUGMENT_P
    from crowded_scenes_ensemble_classification_tpu_torch.ops.augment import draw_decisions

    return draw_decisions(torch.Generator().manual_seed(seed), 1, clip.shape[1:3], OFFLINE_AUGMENT_P)


def offline_plain_frames(torch, clip, seed: int, dev, gates: bool = True):
    """The offline policy's uint8 frames of one decoded clip by the plain
    route: the same decisions, crop, flip and resize on the card, then
    `salt_pepper`'s plain version on the card; with gates=False the salt
    and pepper gates are cleared first (the frames without noise)."""
    from crowded_scenes_ensemble_classification_tpu_torch.data.augment_offline import OFFLINE_OUT_HW
    from crowded_scenes_ensemble_classification_tpu_torch.ops.augment import NOISE_RATIO, crop_flip_resize
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.noise import salt_pepper_plain

    d = offline_decisions(torch, clip, seed).to(dev)
    if not gates:
        off = torch.zeros_like(d.salt)
        d = dataclasses.replace(d, salt=off, pepper=off)
    out = crop_flip_resize(torch.from_numpy(clip).to(dev)[None], OFFLINE_OUT_HW, d)
    out = salt_pepper_plain(out, d.seed, d.salt, d.pepper, NOISE_RATIO)
    return out[0].to(torch.uint8).cpu().numpy()


def check_experiment(torch, np, dev, kernels, tmp: str) -> None:
    """The experiment pipeline through `orchestration`: an I3D experiment of 3
    folds on phase 21's dataset (written here when absent), offline
    augmentation of every fold clip on the card (noise kernel), 2 members
    trained, the recovery list and commands, bf16 and static-int8
    probability caches, SUM and VALIDATION_ERROR_INVERSE evaluation through
    the providers, and the report matrices."""
    from crowded_scenes_ensemble_classification_tpu_torch import data, orchestration as orch, reports
    from crowded_scenes_ensemble_classification_tpu_torch.core.config import ExperimentConfig
    from crowded_scenes_ensemble_classification_tpu_torch.data import augment_offline
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.evaluate import evaluate_ensembles
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.probability_store import load_probabilities
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.int8_conv import int8_conv3d, quantize_int8
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.maxpool import (
        max_pool_3x3x3_same,
        max_pool_3x3x3_same_backward,
    )
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.noise import salt_pepper
    from crowded_scenes_ensemble_classification_tpu_torch.utils.metrics import StageTimer

    counters = {"max_pool_3x3x3_same": max_pool_3x3x3_same, "max_pool_3x3x3_same_backward":
                max_pool_3x3x3_same_backward, "salt_pepper": salt_pepper, "int8_conv3d": int8_conv3d,
                "quantize_int8": quantize_int8}

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def launched():
        return {name: fn.launches for name, fn in counters.items()}

    totals = dict.fromkeys(counters, 0)
    timer = StageTimer()

    def stage(name, items, fn, profiled=False):
        """Run fn() as a timed stage with the counts zeroed first; returns
        (its value, its launches, the card's busy ms or None)."""
        zero()
        if profiled:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                with timer.stage(name, items, dev):
                    out = fn()
        else:
            with timer.stage(name, items, dev):
                out = fn()
        counts = launched()
        for k, v in counts.items():
            totals[k] += v
        return out, counts, device_busy_ms(prof) if profiled else None

    table, write_s = ingest_dataset(data, tmp)
    n_clips = len(table)
    config = ExperimentConfig("I3D", "_SCRATCH", folds_number=EXPERIMENT_FOLDS,
                              augmentation_status="augmented_precomputed", augmentation_frequency=1, epochs=1,
                              batch_size=EXPERIMENT_BATCH)
    work = os.path.join(tmp, "experiment")
    print(f"experiment: {config.subfolder_name()}, {n_clips} clips"
          + (f" (dataset written here in {write_s:.1f} s)" if write_s else " (phase 21's dataset)"))

    # 1. prepare_ensemble: folds, offline augmentation of every clip on the card, splits, manifest.
    layout, counts, _ = stage("prepare", n_clips, lambda: orch.prepare_ensemble(config, table, work))
    check(counts == {**dict.fromkeys(counters, 0), "salt_pepper": n_clips},
          f"prepare launches {counts}: one noise launch a clip expected")
    folds_dir = os.path.join(layout.folds_dir, f"{EXPERIMENT_FOLDS}_folds")
    folds = [data.ClipTable.read_csv(os.path.join(folds_dir, f"fold{i}.csv")) for i in range(EXPERIMENT_FOLDS)]
    check(all(f.columns[-1] == "rgbclips_augmented_0_path" for f in folds)
          and sum(len(f) for f in folds) == n_clips, "the fold CSVs lack rgbclips_augmented_0_path")
    copies = sorted(os.listdir(layout.augmented_dir))
    mtimes = [os.path.getmtime(os.path.join(layout.augmented_dir, f)) for f in copies]
    check(len(copies) == n_clips, f"{len(copies)} augmented copies for {n_clips} clips")
    before = salt_pepper.launches
    augment_offline.augment_folds(folds_dir, layout.augmented_dir, EXPERIMENT_FOLDS, 1)
    check(salt_pepper.launches == before
          and [os.path.getmtime(os.path.join(layout.augmented_dir, f)) for f in copies] == mtimes,
          "a second augment_folds re-encoded copies")
    # The first clip of fold 0 whose copy has its salt and pepper gates on, so that the kernel writes pixels.
    for index, src in enumerate(folds[0]["rgbclips_path"]):
        clip = augment_offline._load_full_clip(src)
        seed = augment_offline.offline_seed(0, 0, index, 0)
        d = offline_decisions(torch, clip, seed)
        if bool(d.salt[0] and d.pepper[0]):
            break
    else:
        raise AssertionError("no copy of fold 0 has both noise gates on")
    kernel_frames = augment_offline.augment_clip(clip, seed, dev)
    check(np.array_equal(kernel_frames, offline_plain_frames(torch, clip, seed, dev)),
          "offline frames differ from the plain route's")
    quiet = offline_plain_frames(torch, clip, seed, dev, gates=False)
    noise_px = int((kernel_frames != quiet).any(-1).sum())
    check(noise_px > 0, "the offline noise kernel changed no pixel with both gates on")
    decoded = data.decode_clip(folds[0]["rgbclips_augmented_0_path"][index], INGEST_FRAMES, None)
    check(decoded.shape == (INGEST_FRAMES, 224, 224, 3), f"augmented copy decodes to {decoded.shape}")
    print(f"prepare_ensemble: {EXPERIMENT_FOLDS} folds {[len(f) for f in folds]}, {n_clips} augmented copies "
          f"({INGEST_FRAMES} frames at {INGEST_HW[0]}×{INGEST_HW[1]} → 224²) in {timer.seconds('prepare'):.2f} s: "
          f"{timer.rate('prepare'):.2f} clips/s offline augmentation (cv2 decode, the policy on the card, mp4 "
          f"encode); {counts['salt_pepper']} noise launches; a second augment_folds encoded nothing; fold 0 clip "
          f"{index}'s frames (salt and pepper gates on, {noise_px} noisy pixels) equal the plain route's")

    # 2. Two members trained (max-pool and its gradient kernels), then the recovery list.
    members = [(0, 1), (0, 2)]
    sizes = {}
    for t, v in members:
        train = data.expand_precomputed_augmentation(
            data.ClipTable.read_csv(layout.split_csv(t, v, "train")), 1)
        sizes[(t, v)] = {k: -(-n // EXPERIMENT_BATCH) for k, n in (
            ("train", len(train)), ("val", len(data.ClipTable.read_csv(layout.split_csv(t, v, "val")))),
            ("test", len(data.ClipTable.read_csv(layout.split_csv(t, v, "test")))))}
        sizes[(t, v)]["clips"] = len(train) + sum(
            len(data.ClipTable.read_csv(layout.split_csv(t, v, k))) for k in ("val", "test"))
    trained_clips = sum(z["clips"] for z in sizes.values())
    results, counts, busy = stage("train", trained_clips, lambda: orch.launch_ensemble_training(
        config, table, work, members=members), profiled=True)
    steps = sum(z["train"] for z in sizes.values())
    evals = sum(z["val"] + z["test"] for z in sizes.values())
    check(counts == {**dict.fromkeys(counters, 0), "max_pool_3x3x3_same": 9 * (steps + evals),
                     "max_pool_3x3x3_same_backward": 9 * steps},
          f"training launches {counts}: {steps} steps and {evals} eval batches")
    losses = [x for r in results.values() for x in r["history"]["loss"] + r["history"]["val_loss"] + [r["test_loss"]]]
    check(sorted(results) == members and all(math.isfinite(x) for x in losses), f"member losses {losses}")
    train_s = timer.seconds("train")
    print(f"launch_ensemble_training: members {members}, 1 epoch each, B={EXPERIMENT_BATCH}, bf16 on f32 master "
          f"weights, {steps} train steps ({trained_clips} clips stepped or evaluated) in {train_s:.2f} s: "
          f"{timer.rate('train'):.2f} clips/s decode-inclusive; card busy {busy:.1f} ms ({busy / (train_s * 1e3):.3f} "
          f"of the profiled stage); losses {[round(x, 4) for x in losses]}; launches {counts}")
    pending = orch.pending_members(config, layout)
    check(pending == [(1, 0), (1, 2), (2, 0), (2, 1)], f"pending members {pending}")
    commands = orch.launch_ensemble_training(config, table, work, runner="commands", recover=True)
    check(len(commands) == 4 and commands == orch.member_cli_commands(config, work, pairs=pending)
          and all(c.startswith(f"python -m {PORT} train") for c in commands), "recovery commands")
    print(f"recovery: pending {pending}, {len(commands)} commands, e.g. {commands[0]!r}")

    # 3. Probability caches of test fold 0: bf16, then static int8 (calibrated on 2 batches).
    n_test = len(data.ClipTable.read_csv(layout.split_csv(0, 1, "test")))
    nb = -(-n_test // EXPERIMENT_BATCH)
    paths = {}
    for name, kw in (("bf16", {}), ("int8static", {"quant": "static"})):
        path, counts, busy = stage(f"probs_{name}", n_test, lambda: orch.cache_probabilities(config, layout, 0, **kw),
                                   profiled=True)
        d = load_probabilities(path)
        probs = torch.from_numpy(d["probs"])
        check_probs(torch, probs, (2, n_test, CLASSES), f"{name} probabilities")
        want = {**dict.fromkeys(counters, 0), "max_pool_3x3x3_same": 9 * 2 * (nb + (2 if kw else 0))}
        if kw:
            want.update(int8_conv3d=57 * 2 * nb, quantize_int8=57 * 2 * nb)
        check(counts == want, f"{name} probability launches {counts}, expected {want}")
        mtime = os.path.getmtime(path)
        zero()
        again = orch.cache_probabilities(config, layout, 0, **kw)
        check(again == path and os.path.getmtime(path) == mtime and launched() == dict.fromkeys(counters, 0),
              f"a second {name} cache_probabilities recomputed")
        paths[name] = path
        secs = timer.seconds(f"probs_{name}")
        print(f"cache_probabilities {name}: {os.path.basename(path)}, (2, {n_test}, {CLASSES}) in {secs:.2f} s: "
              f"{timer.rate(f'probs_{name}'):.2f} clips/s decode-inclusive (members built and loaded"
              f"{', calibrated' if kw else ''}); card busy {busy:.1f} ms ({busy / (secs * 1e3):.3f}); launches "
              f"{counts}; the second call returned the cache")
    check(paths["bf16"] != paths["int8static"], "the bf16 and int8 caches share a path")
    drift = float((torch.from_numpy(load_probabilities(paths["bf16"])["probs"])
                   - torch.from_numpy(load_probabilities(paths["int8static"])["probs"])).abs().max())
    print(f"bf16 vs static int8 probabilities: max |dprob| {drift:.4f} (random-init members; not gated)")

    # 4. Evaluation through the providers (test fold 0: the fold whose members are trained).
    provider = orch.make_prob_provider(config, layout)
    zero()
    res = {scheme: evaluate_ensembles(provider, 1, scheme, name=config.subfolder_name(),
                                      min_val_losses_provider=orch.min_val_losses_provider(config, layout))
           for scheme in ("SUM", "VALIDATION_ERROR_INVERSE")}
    check(launched() == dict.fromkeys(counters, 0), "evaluation recomputed probabilities")
    weights = res["VALIDATION_ERROR_INVERSE"].folds[0].weights
    check(len(weights) == 2 and abs(float(np.sum(weights)) - 1.0) < 1e-6, f"VEI weights {weights}")
    csv_path = res["SUM"].save_predictions_csv(layout.results_dir)
    print(f"evaluate_ensembles on test fold 0: SUM accuracy {res['SUM'].mean_accuracy:.4f}, "
          f"VALIDATION_ERROR_INVERSE {res['VALIDATION_ERROR_INVERSE'].mean_accuracy:.4f} (weights "
          f"{np.round(np.asarray(weights, np.float64), 4).tolist()}), member accuracies "
          f"{res['SUM'].folds[0].member_accuracies}; {os.path.basename(csv_path)} written")

    # 5. Report matrices, and their PDFs where matplotlib imports.
    d = load_probabilities(paths["bf16"])
    cm = reports.row_normalize(reports.confusion_matrix(d["labels"], res["SUM"].folds[0].predictions, CLASSES))
    hist = reports.agreement_histogram(reports.members_correct_per_clip(d["probs"], d["labels"]), 2)
    check(cm.shape == (CLASSES, CLASSES) and hist.sum() == n_test, "report matrices")
    try:
        import matplotlib
    except ImportError as e:
        print(f"reports: matplotlib absent ({e}): matrices computed, PDFs not rendered")
    else:
        pdfs = [reports.render_confusion_pdf(cm, os.path.join(layout.results_dir, "confusion.pdf"), "fold 0",
                                             reports.CROWD11_CLASS_NAMES),
                reports.render_agreement_pdf([hist], os.path.join(layout.results_dir, "agreement.pdf"), 2)]
        check(all(open(p, "rb").read(4) == b"%PDF" for p in pdfs), "report PDFs")
        print(f"reports: matplotlib {matplotlib.__version__}: confusion and agreement PDFs rendered")
    print(f"reports: agreement histogram {hist.tolist()}, confusion diagonal {np.round(np.diag(cm), 3).tolist()}")
    print(f"experiment seconds by stage {({k: round(v, 2) for k, v in timer.totals.items()})}; launches in the phase "
          f"{totals}")
    for k in kernels:
        if k["name"] in totals:
            k["launches_experiment"] = totals[k["name"]]
            k["launches"] += totals[k["name"]]


def ingest_dependencies() -> str:
    """Whether cv2 (video decode, phase 21) and h5py (the Keras h5 reader)
    import on this machine, and their versions."""
    import importlib

    found = []
    for name in ("cv2", "h5py"):
        try:
            found.append(f"{name} {importlib.import_module(name).__version__}")
        except ImportError as e:
            found.append(f"{name} absent ({e})")
    return "ingest dependencies: " + ", ".join(found)


def main() -> int:
    import numpy as np
    import torch

    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels._build import (
        build,
        load_library,
    )
    from crowded_scenes_ensemble_classification_tpu_torch.utils.device import require_cuda

    print(ingest_dependencies())
    smi = require_cuda()  # raises without a CUDA card
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t_start = t0 = time.perf_counter()
    lib, nvcc_s = build()
    load_library()
    print(f"kernels built: {lib.name} (nvcc {nvcc_s:.1f} s, build+load {time.perf_counter() - t0:.1f} s)")
    phase_s = {}

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = round(time.perf_counter() - t, 1)
        return out

    kernels = [phase("maxpool", check_maxpool, torch, dev), phase("noise", check_noise, torch, dev),
               phase("stem", check_stem, torch, dev), phase("maxpool_backward", check_maxpool_backward, torch, dev)]
    phase("small_model", check_small_model, torch, dev)
    phase("main_path", check_main_path, torch, np, dev, kernels)
    bundles, batches, eager, eager_cps = phase("member_path", check_member_path, torch, np, dev, kernels)
    phase("serving", check_serving, torch, bundles, batches, eager, eager_cps)
    del bundles, batches, eager
    torch.cuda.empty_cache()
    phase("serving_forms", check_serving_forms, torch, np, dev)
    torch.cuda.empty_cache()
    phase("stem_backward", check_stem_backward, torch, dev)
    phase("training", check_training, torch, np, dev, kernels)
    phase("zoo", check_zoo, torch, dev)
    families = phase("hetero_members", hetero_families, torch)
    phase("hetero", check_hetero, torch, dev, families, kernels, False)
    phase("evaluation", check_evaluation, torch, np, dev, families)
    phase("flow", check_flow, torch, np, dev)
    phase("hetero_flow", check_hetero, torch, dev, families, kernels, True)
    del families
    torch.cuda.empty_cache()
    phase("twostream", check_twostream, torch, np, dev, kernels)
    torch.cuda.empty_cache()
    phase("train_zoo", check_train_zoo, torch, np, dev, kernels)
    torch.cuda.empty_cache()
    phase("int8", check_int8, torch, np, dev, kernels)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        phase("ingest", check_ingest, torch, np, dev, kernels, tmp)
        torch.cuda.empty_cache()
        phase("experiment", check_experiment, torch, np, dev, kernels, tmp)

    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s; seconds by phase {phase_s}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

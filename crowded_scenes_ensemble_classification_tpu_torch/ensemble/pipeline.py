"""The ensemble steps of the JAX package's benchmark, which are not package
modules there.

- The main path, `resident_ensemble_step` (JAX `bench.py:1126-1147`): slice
  a batch of rows from the resident buffer, decode I420 to BGR, run the
  Crowd-11 augment (crop/flip folded into one bilinear resize, then the
  salt/pepper kernel), cast once to the members' dtype, stage the s2d stem
  once, run the members in order, softmax, SUM fusion, argmax.
- The heterogeneous step, `hetero_ensemble_step` (JAX `bench.py:560-607`,
  the reference's global ensemble, evaluate_ensemble.py:1329-1474): members
  of several families classify the same clips and are SUM-fused together,
  the TwoStream members on flow computed on the card by turbo Farnebäck.
- The resident TwoStream pipeline, `twostream_ensemble_step` (JAX
  `bench.py:1366-1390`): the main path's decode and augment, then turbo
  Farnebäck of the augmented clips' gray frames, then TwoStream members on
  the shared s2d stagings of rgb and flow.
- The wire-fed main path, `wire_ensemble_step` (JAX `bench.py:946-971`):
  the batch arrives as one step's ragged wire (`data.wire_format`) instead
  of resident rows; unpack, the windowed augment on the plan's decisions,
  then the main path's cast, staging, members and fusion.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..data.wire_format import WirePlan, i420_to_bgr_u8, make_wire_unpack
from ..flow.farneback import FLOW_CHUNK_PAIRS, TURBO_PARAMS, farneback_flow_batch, rgb_to_gray
from ..models.common import s2d_stem_stage
from ..models.i3d import I3D
from ..models.two_stream_i3d import TwoStreamI3D
from ..ops.augment import (
    AugmentDecisions,
    crowd11_augment_from_decisions,
    crowd11_augment_windowed_from_decisions,
    draw_decisions,
)
from .fusion import fuse_predictions, sum_weights
from .members import _softmax_stack, check_member_form, shared_stem_probabilities

AUGMENT_P = 0.75  # on-the-fly augment probability (JAX bench.py:85)
SMALL_CLIP_FRAMES = 16  # C3D/R3D clips: 16 frames at 112², from the 224² clips (JAX bench.py:569-572)


def clip_flow(clips: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, 3) BGR clips → (B, T, H, W, 2) turbo Farnebäck flow of
    each frame to the next, the last frame paired with the first
    (`jnp.roll(gray, -1, axis=1)`, JAX bench.py:564-567, :1379-1382): T
    fields a clip, never scaled, in chunks of the bench's 4 clips of 20
    frames (TWOSTREAM_FLOW_CHUNK · FRAMES, bench.py:96), FLOW_CHUNK_PAIRS."""
    gray = rgb_to_gray(clips)
    return farneback_flow_batch(gray, torch.roll(gray, -1, dims=1), chunk_pairs=FLOW_CHUNK_PAIRS, **TURBO_PARAMS)


def ensemble_step_from_decisions(
    members: Sequence[I3D],
    rows: torch.Tensor,
    decisions: AugmentDecisions,
    frames: int,
    staging: int,
    out_hw: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """rows (B, frames·staging²·3/2) u8 I420 → ((M, B, C) probabilities,
    (B,) fused predictions), with the augment decisions given."""
    batch = i420_to_bgr_u8(rows, frames, staging, staging)
    x = crowd11_augment_from_decisions(batch, out_hw, decisions)
    x = x.to(members[0].dtype)  # cast once, shared by all members
    probs = shared_stem_probabilities(members, x)
    return probs, fuse_predictions(probs, sum_weights(len(members)))


def resident_ensemble_step(
    members: Sequence[I3D],
    resident_i420: torch.Tensor,
    batch_index: int,
    generator: torch.Generator,
    *,
    batch_size: int,
    frames: int,
    staging: int,
    out_hw: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the main path.  `resident_i420` is (N, frames·staging²·3/2)
    u8 on the members' device; the step takes batch `batch_index` modulo
    N // batch_size.  Decisions come from `generator` (a CPU generator keeps
    the draws off the card)."""
    rows, decisions = _resident_batch(resident_i420, batch_index, generator, batch_size, staging)
    return ensemble_step_from_decisions(members, rows, decisions, frames, staging, out_hw)


def wire_ensemble_step(
    members: Sequence[I3D],
    wire: torch.Tensor,
    offsets,
    plan: WirePlan,
    step: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the main path fed by the wire (JAX bench.py:946-971):
    `wire` is step `step`'s packed (cap,) u8 buffer of `plan`
    (`pack_ragged_windows`; on the host, pinned by `pinned_wire`, it is
    copied `non_blocking`), `offsets` its (B,) offsets.  Unpack on the
    members' device, the windowed augment with the plan's decisions of the
    step (salt/pepper kernel), cast once, one s2d staging, the members in
    order → ((M, B, C) probabilities, (B,) SUM-fused predictions)."""
    dev = next(members[0].parameters()).device
    windows = make_wire_unpack(plan)(torch.as_tensor(wire).to(dev, non_blocking=True), offsets, step)
    x = crowd11_augment_windowed_from_decisions(windows, plan.out_hw, plan.staging_hw, plan.decisions[step],
                                                plan.crop_margin)
    probs = shared_stem_probabilities(members, x.to(members[0].dtype))
    return probs, fuse_predictions(probs, sum_weights(len(members)))


def _resident_batch(resident_i420: torch.Tensor, batch_index: int, generator: torch.Generator,
                    batch_size: int, staging: int) -> Tuple[torch.Tensor, AugmentDecisions]:
    """Batch `batch_index` (modulo N // batch_size) of the resident rows and
    its augment decisions drawn from `generator`."""
    n_batches = resident_i420.shape[0] // batch_size
    start = (batch_index % n_batches) * batch_size
    decisions = draw_decisions(generator, batch_size, (staging, staging), AUGMENT_P)
    return resident_i420[start : start + batch_size], decisions


def twostream_step_from_decisions(
    members: Sequence[TwoStreamI3D],
    rows: torch.Tensor,
    decisions: AugmentDecisions,
    frames: int,
    staging: int,
    out_hw: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """rows (B, frames·staging²·3/2) u8 I420 → ((M, B, C) probabilities,
    (B,) fused predictions) of `stem_prestaged` TwoStream members, with the
    augment decisions given: decode, augment (salt/pepper kernel), flow of
    the augmented clips, one s2d staging each of rgb and flow in the
    members' dtype (JAX bench.py:1366-1390)."""
    check_member_form(members, share_stem_staging=True)
    with torch.inference_mode():
        batch = i420_to_bgr_u8(rows, frames, staging, staging)
        x = crowd11_augment_from_decisions(batch, out_hw, decisions)
        flows = clip_flow(x)
        dt = members[0].dtype
        probs = _softmax_stack(members, s2d_stem_stage(x.to(dt)), s2d_stem_stage(flows.to(dt)))
        return probs, fuse_predictions(probs, sum_weights(len(members)))


def twostream_ensemble_step(
    members: Sequence[TwoStreamI3D],
    resident_i420: torch.Tensor,
    batch_index: int,
    generator: torch.Generator,
    *,
    batch_size: int,
    frames: int,
    staging: int,
    out_hw: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the resident TwoStream pipeline, with the arguments of
    `resident_ensemble_step`: batch `batch_index` of the resident rows,
    decisions drawn from `generator`."""
    rows, decisions = _resident_batch(resident_i420, batch_index, generator, batch_size, staging)
    return twostream_step_from_decisions(members, rows, decisions, frames, staging, out_hw)


def hetero_ensemble_step(
    families: Dict[str, Sequence[nn.Module]],
    rgb224: torch.Tensor,
    flow224: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One heterogeneous ensemble step (JAX `bench.py:560-607`).

    `families` maps a model type ("I3D", "TWOSTREAM_I3D", "C3D", "R3D_*")
    to its members, in the order they run; I3D and TwoStream members are
    `stem_prestaged`.  rgb224 is (B, 20, 224, 224, 3) BGR, 0-255, on the
    members' device.  flow224 is precomputed flow (B, 20, 224, 224, 2) there,
    or None: then the step computes it from rgb224 as the JAX bench does
    (`clip_flow`: turbo Farnebäck of each gray frame to the next, the last
    to the first), once, if a TwoStream family is present.
    One s2d staging of rgb224 feeds I3D and the TwoStream rgb trunk, one of
    the flow the TwoStream flow trunk; C3D and R3D take
    `rgb224[:, :16, ::2, ::2]` (their 16×112² geometry).  Each input is cast
    once to the members' dtype.  → ((M, B, C) float32 softmax of every
    member in order, (B,) SUM-fused predictions)."""
    inputs: Dict[Tuple[str, Optional[torch.dtype]], torch.Tensor] = {}

    def flow() -> torch.Tensor:
        if flow224 is not None:
            return flow224
        if ("flow", None) not in inputs:
            inputs["flow", None] = clip_flow(rgb224)
        return inputs["flow", None]

    def shared(kind: str, dtype: torch.dtype) -> torch.Tensor:
        if (kind, dtype) not in inputs:
            if kind == "small":
                inputs[kind, dtype] = rgb224[:, :SMALL_CLIP_FRAMES, ::2, ::2].to(dtype).contiguous()
            else:
                inputs[kind, dtype] = s2d_stem_stage((rgb224 if kind == "rgb" else flow()).to(dtype))
        return inputs[kind, dtype]

    probs = []
    with torch.inference_mode():
        for model_type, members in families.items():
            check_member_form(members, share_stem_staging=model_type in ("I3D", "TWOSTREAM_I3D"))
            dt = members[0].dtype
            if model_type == "I3D":
                args = (shared("rgb", dt),)
            elif model_type == "TWOSTREAM_I3D":
                args = (shared("rgb", dt), shared("flow", dt))
            elif model_type == "C3D" or model_type.startswith("R3D_"):
                args = (shared("small", dt),)
            else:
                raise ValueError(f"Unknown model_type {model_type!r}")
            probs.append(_softmax_stack(members, *args))
        probs = torch.cat(probs)
        return probs, fuse_predictions(probs, sum_weights(probs.shape[0]))

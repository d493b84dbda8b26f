"""The ensemble steps of the JAX package's benchmark, which are not package
modules there.

- The main path, `resident_ensemble_step` (JAX `bench.py:1126-1147`): slice
  a batch of rows from the resident buffer, decode I420 to BGR, run the
  Crowd-11 augment (crop/flip folded into one bilinear resize, then the
  salt/pepper kernel), cast once to the members' dtype, stage the s2d stem
  once, run the members in order, softmax, SUM fusion, argmax.
- The heterogeneous step, `hetero_ensemble_step` (JAX `bench.py:560-607`,
  the reference's global ensemble, evaluate_ensemble.py:1329-1474): members
  of several families classify the same clips and are SUM-fused together.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn

from ..data.wire_format import i420_to_bgr_u8
from ..models.common import s2d_stem_stage
from ..models.i3d import I3D
from ..ops.augment import AugmentDecisions, crowd11_augment_from_decisions, draw_decisions
from .fusion import fuse_predictions, sum_weights
from .members import _softmax_stack, check_member_form, shared_stem_probabilities

AUGMENT_P = 0.75  # on-the-fly augment probability (JAX bench.py:85)
SMALL_CLIP_FRAMES = 16  # C3D/R3D clips: 16 frames at 112², from the 224² clips (JAX bench.py:569-572)


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
    n_batches = resident_i420.shape[0] // batch_size
    start = (batch_index % n_batches) * batch_size
    rows = resident_i420[start : start + batch_size]
    decisions = draw_decisions(generator, batch_size, (staging, staging), AUGMENT_P)
    return ensemble_step_from_decisions(members, rows, decisions, frames, staging, out_hw)


def hetero_ensemble_step(
    families: Dict[str, Sequence[nn.Module]],
    rgb224: torch.Tensor,
    flow224: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One heterogeneous ensemble step (JAX `bench.py:560-607`).

    `families` maps a model type ("I3D", "TWOSTREAM_I3D", "C3D", "R3D_*")
    to its members, in the order they run; I3D and TwoStream members are
    `stem_prestaged`.  rgb224 is (B, 20, 224, 224, 3) and flow224 the
    precomputed flow, (B, 20, 224, 224, 2), both on the members' device.
    One s2d staging of rgb224 feeds I3D and the TwoStream rgb trunk, one of
    flow224 the TwoStream flow trunk; C3D and R3D take
    `rgb224[:, :16, ::2, ::2]` (their 16×112² geometry).  Each input is cast
    once to the members' dtype.  → ((M, B, C) float32 softmax of every
    member in order, (B,) SUM-fused predictions)."""
    inputs: Dict[Tuple[str, torch.dtype], torch.Tensor] = {}

    def shared(kind: str, dtype: torch.dtype) -> torch.Tensor:
        if (kind, dtype) not in inputs:
            if kind == "small":
                inputs[kind, dtype] = rgb224[:, :SMALL_CLIP_FRAMES, ::2, ::2].to(dtype).contiguous()
            else:
                inputs[kind, dtype] = s2d_stem_stage((rgb224 if kind == "rgb" else flow224).to(dtype))
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

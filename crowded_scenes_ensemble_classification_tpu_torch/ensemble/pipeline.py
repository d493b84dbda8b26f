"""The main path: one ensemble step over resident I420 clip rows.

Counterpart of the resident-ingest step of the JAX package's benchmark
(`bench.py:1126-1147`), which is not a package module there: slice a batch
of rows from the resident buffer, decode I420 to BGR, run the Crowd-11
augment (crop/flip folded into one bilinear resize, then the salt/pepper
kernel), cast once to the members' dtype, stage the s2d stem once, run the
members in order, softmax, SUM fusion, argmax.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..data.wire_format import i420_to_bgr_u8
from ..models.i3d import I3D
from ..ops.augment import AugmentDecisions, crowd11_augment_from_decisions, draw_decisions
from .fusion import fuse_predictions, sum_weights
from .members import shared_stem_probabilities

AUGMENT_P = 0.75  # on-the-fly augment probability (JAX bench.py:85)


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

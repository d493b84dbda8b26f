"""Ensemble inference over I3D members that share one stem staging.

Counterpart of `crowded_scenes_ensemble_classification_tpu/ensemble/members.py`
(`make_member_forward` with share_stem_staging=True, lines 165-257, and
`member_probabilities`, lines 289-329) on one card: the s2d stem staging is
computed once per batch, and the members run one after another — what
`lax.map` does there (members.py:236) — which keeps one member's
activations alive at a time.

Members are `models.i3d.I3D(stem_prestaged=True)` modules in eval mode.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Sequence, Tuple

import numpy as np
import torch

from ..models.common import s2d_stem_stage
from ..models.i3d import I3D
from ..ops.augment import identity_resize_batch


def shared_stem_probabilities(members: Sequence[I3D], x: torch.Tensor) -> torch.Tensor:
    """NTHWC clips at the model size → (M, B, C) float32 softmax, with the
    stem staging computed once and the members run in order."""
    xs = s2d_stem_stage(x)
    with torch.inference_mode():
        return torch.stack([torch.softmax(m(xs), dim=-1) for m in members])


def make_member_forward(
    members: Sequence[I3D],
    out_hw: Tuple[int, int],
    input_scale: float = 1.0,
) -> Callable[[Dict], torch.Tensor]:
    """Returns fn(batch) → (M, B, C) softmax probabilities.  `batch['rgb']`
    is (B, T, H, W, 3) on the members' device; it is resized to `out_hw`,
    scaled by `input_scale` (the scale the members trained with) and cast
    to the members' dtype (JAX prepare_member_inputs, members.py:40-91)."""
    for m in members:
        if not m.trunk.stem_prestaged:
            raise ValueError("shared stem staging needs I3D(stem_prestaged=True) members")
    dtype = members[0].dtype

    def forward(batch: Dict) -> torch.Tensor:
        rgb = identity_resize_batch(batch["rgb"], out_hw) * input_scale
        return shared_stem_probabilities(members, rgb.to(dtype))

    return forward


def member_probabilities(
    members: Sequence[I3D],
    batches: Iterable[Dict],
    out_hw: Tuple[int, int],
    input_scale: float = 1.0,
) -> np.ndarray:
    """Run every member over an iterable of batches → (M, N, C) float32 in
    batch order, keeping the rows a batch marks `valid` (all rows when it
    has no 'valid')."""
    forward = make_member_forward(members, out_hw, input_scale)
    device = next(members[0].parameters()).device
    chunks = []
    for batch in batches:
        rgb = torch.as_tensor(np.asarray(batch["rgb"])).to(device)
        probs = forward({"rgb": rgb}).cpu().numpy()
        valid = np.asarray(batch.get("valid", np.ones(probs.shape[1], bool)), bool)
        chunks.append(probs[:, valid])
    return np.concatenate(chunks, axis=1)

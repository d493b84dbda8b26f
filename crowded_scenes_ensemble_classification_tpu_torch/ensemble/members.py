"""Ensemble inference over I3D members on one card.

Counterpart of `crowded_scenes_ensemble_classification_tpu/ensemble/members.py`
(`prepare_member_inputs`, lines 40-91; `make_member_forward`, 165-257;
`member_probabilities`, 289-329).  The members run one after another,
which is what `lax.map` does there (members.py:236), so one member's
activations are alive at a time.  Two forms:

- unshared (the default, as there): every member takes the resized clips
  and runs its own stem, the hand-written stem kernel for members built
  with `stem_impl='pallas'`;
- shared stem staging: the s2d staging is computed once per batch and fed
  to `I3D(stem_prestaged=True)` members (the main path's form).

`stack_variables` and `get_member_forward` have no counterpart: they stack
flax pytrees for `vmap` and cache `jit`ted forwards, and here each member
is an `nn.Module` run eagerly.  The member-sharded mesh form and
`calibrate_members` are not ported yet (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Sequence, Tuple

import numpy as np
import torch

from ..models.common import s2d_stem_stage
from ..models.i3d import I3D
from ..ops.augment import identity_resize_batch


def _softmax_stack(members: Sequence[I3D], x: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.softmax(m(x), dim=-1) for m in members])


def shared_stem_probabilities(members: Sequence[I3D], x: torch.Tensor) -> torch.Tensor:
    """NTHWC clips at the model size → (M, B, C) float32 softmax, with the
    stem staging computed once and the members run in order."""
    xs = s2d_stem_stage(x)
    with torch.inference_mode():
        return _softmax_stack(members, xs)


def prepare_member_inputs(
    batch: Dict,
    out_hw: Tuple[int, int],
    two_stream: bool,
    input_scale: float = 1.0,
) -> Dict:
    """The member forward's preprocessing: rgb resized to the model's
    `out_hw` and scaled by `input_scale` (the scale the members trained
    with), float32.  Flow inputs wait for `flow/` (ROADMAP Queue 1 item 9)."""
    if two_stream:
        raise NotImplementedError("two-stream inputs need flow/, not ported yet (ROADMAP Queue 1 item 9)")
    return {"rgb": identity_resize_batch(batch["rgb"], out_hw) * input_scale}


def check_member_form(members: Sequence[I3D], share_stem_staging: bool) -> None:
    """Shared staging needs `stem_prestaged` members; the unshared form
    needs members that take clips."""
    for m in members:
        if m.trunk.stem_prestaged != share_stem_staging:
            raise ValueError(
                "shared stem staging needs I3D(stem_prestaged=True) members"
                if share_stem_staging
                else "the unshared forward needs members that take clips, not I3D(stem_prestaged=True)"
            )


def member_softmax(
    members: Sequence[I3D],
    batch: Dict,
    out_hw: Tuple[int, int],
    share_stem_staging: bool = False,
    input_scale: float = 1.0,
) -> torch.Tensor:
    """batch['rgb'] (B, T, H, W, 3) on the members' device → (M, B, C)
    float32 softmax.  Opens no autograd context, so `torch.export` can
    trace it; callers that run it eagerly wrap it in `inference_mode`."""
    x = prepare_member_inputs(batch, out_hw, False, input_scale)["rgb"].to(members[0].dtype)
    if share_stem_staging:
        x = s2d_stem_stage(x)
    return _softmax_stack(members, x)


def make_member_forward(
    members: Sequence[I3D],
    out_hw: Tuple[int, int],
    share_stem_staging: bool = False,
    input_scale: float = 1.0,
) -> Callable[[Dict], torch.Tensor]:
    """Returns fn(batch) → (M, B, C) softmax probabilities.  `batch['rgb']`
    is (B, T, H, W, 3) on the members' device; it is resized to `out_hw`,
    scaled by `input_scale` and cast to the members' dtype, then each member
    runs on it (unshared) or on its s2d staging (shared)."""
    check_member_form(members, share_stem_staging)

    def forward(batch: Dict) -> torch.Tensor:
        with torch.inference_mode():
            return member_softmax(members, batch, out_hw, share_stem_staging, input_scale)

    return forward


def member_probabilities(
    members: Sequence[I3D],
    batches: Iterable[Dict],
    out_hw: Tuple[int, int],
    input_scale: float = 1.0,
) -> np.ndarray:
    """Run every member over an iterable of batches → (M, N, C) float32 in
    batch order, keeping the rows a batch marks `valid` (all rows when it
    has no 'valid').  I3D members share the stem staging, as in JAX
    members.py:305-320, so they are `stem_prestaged` members."""
    forward = make_member_forward(members, out_hw, share_stem_staging=True, input_scale=input_scale)
    device = next(members[0].parameters()).device
    chunks = []
    for batch in batches:
        rgb = torch.as_tensor(np.asarray(batch["rgb"])).to(device)
        probs = forward({"rgb": rgb}).cpu().numpy()
        valid = np.asarray(batch.get("valid", np.ones(probs.shape[1], bool)), bool)
        chunks.append(probs[:, valid])
    return np.concatenate(chunks, axis=1)

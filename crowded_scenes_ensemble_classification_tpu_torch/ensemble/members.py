"""Ensemble inference over the members of one model family on one card.

Counterpart of `crowded_scenes_ensemble_classification_tpu/ensemble/members.py`
(`prepare_member_inputs`, lines 40-91; `make_member_forward`, 165-257;
`member_probabilities`, 289-329).  The members run one after another,
which is what `lax.map` does there (members.py:236), so one member's
activations are alive at a time.  Members are the modules of one family
(I3D, TwoStreamI3D, C3D or R3D).  Two forms:

- unshared (the default, as there): every member takes the resized clips
  and runs its own stem, the hand-written stem kernel for I3D members built
  with `stem_impl='pallas'`;
- shared stem staging (I3D and TwoStream only): the s2d staging is computed
  once per batch, for TwoStream of both rgb and flow, and fed to
  `stem_prestaged=True` members (the main path's form).

Two-stream members take precomputed flow (`batch['flow']`, 0-255 imagery
as in the reference's TVL1_precomputed mode, so `input_scale` applies to
it) or gray pairs (`batch['gray']`, `batch['gray_next']`), from which
Farnebäck computes the flow on the members' device (displacement, so
`input_scale` does not apply).
`stack_variables` (JAX members.py:30-32) stacks the members' state dicts
along a leading member axis, and `stacked_member_softmax` runs one template
module over such a stack: the form of a serving artifact that takes its
parameters at call time (`serving.export_ensemble(bake_params=False)`).
`member_probabilities` and `calibrate_members` read their batches from a
`data.pipeline.BatchPipeline` (decoded by its thread pool or read from its
clip cache, and prefetched by `prefetch_batches` while the card runs the
batch before, as JAX members.py:113-146, :322-325) or from any iterable of
batch dicts; host uint8 batches move to the members' device here.
`get_member_forward` has no counterpart: it caches `jit`ted forwards, and
here each member is an `nn.Module` run eagerly.  `calibrate_members` (JAX
members.py:94-162) makes static-int8 members.  The member-sharded mesh form
is not ported yet (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..data.pipeline import iterate_batches
from ..flow.farneback import gray_pair_flow
from ..models.common import s2d_stem_stage
from ..models.i3d import I3D
from ..models.quantize import calibrate, quantize_variables, set_quant_mode
from ..models.two_stream_i3d import TwoStreamI3D
from ..ops.augment import identity_resize_batch


def _softmax_stack(members: Sequence[nn.Module], *inputs: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.softmax(m(*inputs), dim=-1) for m in members])


def stack_variables(states: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """M same-architecture state dicts → one dict of (M, ...) tensors (JAX
    members.py:30-32).  Each member's slice keeps the strides its tensor had
    (channels_last_3d conv weights stay so), so a module run on a slice
    computes as it does on its own weights."""
    keys = list(states[0])
    if any(list(s) != keys for s in states[1:]):
        raise ValueError("stack_variables: the state dicts hold different keys")
    out = {}
    for k in keys:
        first = states[0][k]
        channels_last = first.dim() == 5 and first.is_contiguous(memory_format=torch.channels_last_3d)
        if not (first.is_contiguous() or channels_last):
            first = first.contiguous()
        stacked = torch.empty_strided((len(states),) + tuple(first.shape), (first.numel(),) + first.stride(),
                                      dtype=first.dtype, device=first.device)
        for i, s in enumerate(states):
            if s[k].shape != first.shape:
                raise ValueError(f"stack_variables: {k} has shapes {tuple(first.shape)} and {tuple(s[k].shape)}")
            stacked[i].copy_(s[k])
        out[k] = stacked
    return out


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
    flow_fast_warp: bool = False,
    flow_params: Optional[dict] = None,
) -> Dict:
    """The member forward's preprocessing, float32 (JAX members.py:40-91):
    rgb resized to the model's `out_hw` and scaled by `input_scale` (the
    scale the members trained with); for two-stream members the precomputed
    flow, resized and scaled alike, or else Farnebäck flow from the gray
    pairs `batch['gray']` → `batch['gray_next']` (B, T, H, W, 1) by
    `flow.farneback.gray_pair_flow` with `flow_params` (or the full
    schedule) and `flow_fast_warp`, not scaled, since it is displacement."""
    inputs = {"rgb": identity_resize_batch(batch["rgb"], out_hw) * input_scale}
    if two_stream:
        if "flow" in batch:
            inputs["flow"] = identity_resize_batch(batch["flow"], out_hw) * input_scale
        else:
            inputs["flow"] = gray_pair_flow(batch["gray"], batch["gray_next"], out_hw, flow_fast_warp, flow_params)
    return inputs


def check_member_form(members: Sequence[nn.Module], share_stem_staging: bool) -> None:
    """The members are of one family; shared staging needs I3D-family
    members built with `stem_prestaged`, and the unshared form members
    that take clips."""
    if len({type(m) for m in members}) != 1:
        raise ValueError("the members of one forward must be of one family")
    if not isinstance(members[0], (I3D, TwoStreamI3D)):
        if share_stem_staging:
            raise ValueError("share_stem_staging supports I3D-family models")
        return
    for m in members:
        if m.stem_prestaged != share_stem_staging:
            raise ValueError(
                "shared stem staging needs stem_prestaged=True members"
                if share_stem_staging
                else "the unshared forward needs members that take clips, not stem_prestaged=True ones"
            )


def _member_inputs(members: Sequence[nn.Module], batch: Dict, out_hw: Tuple[int, int], share_stem_staging: bool,
                   input_scale: float, flow_fast_warp: bool, flow_params: Optional[dict]) -> List[torch.Tensor]:
    """The members' positional inputs of one batch: preprocessed, cast once
    to their dtype and, shared, staged once."""
    two_stream = isinstance(members[0], TwoStreamI3D)
    inputs = prepare_member_inputs(batch, out_hw, two_stream, input_scale, flow_fast_warp, flow_params)
    xs = [inputs[k].to(members[0].dtype) for k in (("rgb", "flow") if two_stream else ("rgb",))]
    return [s2d_stem_stage(x) for x in xs] if share_stem_staging else xs


def _on_device(batch: Dict, device: torch.device) -> Dict:
    return {k: torch.as_tensor(batch[k]).to(device) for k in ("rgb", "flow", "gray", "gray_next") if k in batch}


def calibrate_members(
    members: Sequence[nn.Module],
    batches: Iterable[Dict],
    out_hw: Tuple[int, int],
    num_batches: int = 2,
    input_scale: float = 1.0,
    flow_fast_warp: bool = False,
    flow_params: Optional[dict] = None,
) -> List[nn.Module]:
    """Static-int8 calibration of every member (JAX members.py:94-162).
    `members` are of one family, built with quant='calib' (I3D and
    TwoStream with `stem_prestaged`: they calibrate through the shared s2d
    staging that `member_probabilities` feeds them, so the prestaged stem
    records its own scale).  The first `num_batches` of `batches` (a
    `BatchPipeline`, whose epoch 0 is prefetched and whose producer is
    stopped once they are taken, or an iterable of dicts as
    `member_probabilities` takes) are preprocessed once, exactly as
    for inference, and run through each member; then its weights are baked
    (`models.quantize.quantize_variables`) and it is switched to 'static'.
    Returns the members, ready for `member_probabilities` and
    `make_member_forward` unchanged."""
    share = isinstance(members[0], (I3D, TwoStreamI3D))
    check_member_form(members, share)
    device = next(members[0].parameters()).device
    with torch.inference_mode(), iterate_batches(batches) as stream:
        arg_sets = [tuple(_member_inputs(members, _on_device(b, device), out_hw, share, input_scale,
                                         flow_fast_warp, flow_params))
                    for b in itertools.islice(stream, num_batches)]
    if not arg_sets:
        raise ValueError("calibrate_members: no batches")
    for m in members:
        set_quant_mode(quantize_variables(calibrate(m, arg_sets)), "static")
    return list(members)


def member_softmax(
    members: Sequence[nn.Module],
    batch: Dict,
    out_hw: Tuple[int, int],
    share_stem_staging: bool = False,
    input_scale: float = 1.0,
    flow_fast_warp: bool = False,
    flow_params: Optional[dict] = None,
) -> torch.Tensor:
    """batch['rgb'] (B, T, H, W, 3), and for TwoStream members batch['flow']
    (B, T, H, W, 2) or the gray pairs batch['gray'] and batch['gray_next']
    (B, T, H, W, 1), on the members' device → (M, B, C) float32 softmax.
    Opens no autograd context, so `torch.export` can trace it; callers that
    run it eagerly wrap it in `inference_mode`."""
    xs = _member_inputs(members, batch, out_hw, share_stem_staging, input_scale, flow_fast_warp, flow_params)
    return _softmax_stack(members, *xs)


def stacked_member_softmax(
    template: nn.Module,
    stacked: Dict[str, torch.Tensor],
    batch: Dict,
    out_hw: Tuple[int, int],
    share_stem_staging: bool = False,
    input_scale: float = 1.0,
    flow_fast_warp: bool = False,
    flow_params: Optional[dict] = None,
) -> torch.Tensor:
    """`member_softmax` of the members whose state dicts `stack_variables`
    stacked, each run as `template` (a module of their architecture and
    form) on its slice of `stacked` by `torch.func.functional_call`: the
    template's own parameters and buffers are never read, so the members
    are whatever `stacked` holds (JAX members.py:165-257 with stacked
    variables).  A static-int8 template computes its packed operands from
    each slice; hold none on it (`refresh_static_operands` on the meta
    device), or they are what it runs."""
    xs = tuple(_member_inputs([template], batch, out_hw, share_stem_staging, input_scale, flow_fast_warp,
                              flow_params))
    count = next(iter(stacked.values())).shape[0]
    return torch.stack([
        torch.softmax(torch.func.functional_call(template, {k: v[i] for k, v in stacked.items()}, xs), dim=-1)
        for i in range(count)
    ])


def make_member_forward(
    members: Sequence[nn.Module],
    out_hw: Tuple[int, int],
    share_stem_staging: bool = False,
    input_scale: float = 1.0,
    flow_fast_warp: bool = False,
    flow_params: Optional[dict] = None,
) -> Callable[[Dict], torch.Tensor]:
    """Returns fn(batch) → (M, B, C) softmax probabilities.  `batch['rgb']`
    (and for TwoStream `batch['flow']`, or the gray pairs Farnebäck turns
    into flow with `flow_params` and `flow_fast_warp`) is (B, T, H, W, C)
    on the members' device; it is resized to `out_hw`, scaled by
    `input_scale` (computed flow is not) and cast to the members' dtype,
    then each member runs on it (unshared) or on its s2d staging (shared)
    (JAX members.py:165-257)."""
    check_member_form(members, share_stem_staging)

    def forward(batch: Dict) -> torch.Tensor:
        with torch.inference_mode():
            return member_softmax(members, batch, out_hw, share_stem_staging, input_scale,
                                  flow_fast_warp, flow_params)

    return forward


def member_probabilities(
    members: Sequence[nn.Module],
    batches: Iterable[Dict],
    out_hw: Tuple[int, int],
    input_scale: float = 1.0,
    flow_params: Optional[dict] = None,
) -> np.ndarray:
    """Run every member over the batches → (M, N, C) float32 in batch
    order, keeping the rows a batch marks `valid` (all rows when it has no
    'valid').  `batches` is a `BatchPipeline` (its epoch 0, prefetched: the
    host decodes the next batch while the card runs this one; its rows in
    the pipeline's order, dataset order when it does not shuffle) or an
    iterable of batch dicts, on the host or the members' device.  I3D and
    TwoStream members share the stem staging, as in JAX members.py:305-320,
    so they are `stem_prestaged` members; C3D and R3D members run
    unshared.  TwoStream batches carry `flow` or the gray pairs;
    flow_params must be the Farnebäck schedule the members trained with
    (`flow.farneback.flow_schedule_params`)."""
    share = isinstance(members[0], (I3D, TwoStreamI3D))
    forward = make_member_forward(members, out_hw, share_stem_staging=share, input_scale=input_scale,
                                  flow_params=flow_params)
    device = next(members[0].parameters()).device
    chunks = []
    with iterate_batches(batches) as stream:
        for batch in stream:
            probs = forward(_on_device(batch, device)).cpu().numpy()
            valid = np.asarray(batch.get("valid", np.ones(probs.shape[1], bool)), bool)
            chunks.append(probs[:, valid])
    return np.concatenate(chunks, axis=1)

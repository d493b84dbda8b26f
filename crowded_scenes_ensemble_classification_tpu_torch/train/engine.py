"""The training and evaluation engine: the train and eval steps and the epoch loop.

Counterpart of `crowded_scenes_ensemble_classification_tpu/train/engine.py`
(lines 40-751), which maps the reference's `train()` and `evaluate()`
(train.py:1786-1971) onto the device.  One train step:

    (gather the batch's resident rows) → uint8 → Crowd-11 augment (crop and
    flip as one bilinear resize, then the salt/pepper kernel) or a plain
    resize → × input_scale; for TwoStream the flow: precomputed (resized,
    × input_scale) or Farnebäck of the gray pairs (optionally of the pairs
    augmented with the rgb stream's decisions) → forward in train mode
    (BatchNorm on batch statistics, C3D's dropout) → masked,
    class-weighted cross-entropy (+ R3D's l2) → backward (through the
    max-pool backward kernel) → optimizer step.

The JAX package jits each step; here it runs eagerly on the module's
device, and the state is updated in place.  Augment decisions come from a
CPU `torch.Generator` seeded by (state.seed, state.step), and C3D's dropout
masks from a generator on the module's device seeded by (state.seed,
state.step, 1), so a resumed run draws what an uninterrupted one would.
Epoch-level control (LR policy, early stopping, best-val checkpoint, NaN
stop) runs on the host in `fit`, with the reference's callback semantics
(callbacks.py).

`fit` and `evaluate_model` read a `data.pipeline.BatchPipeline` through
`prefetch_batches` (host decode of the next batch overlaps the step, JAX
engine.py:542-544, :682-685), a `ResidentClips` through its `batches(epoch)`
and the resident steps, or any other object with `batches(epoch)`.

Every step and `fit` take a `mesh` (`core.mesh`): the step is then
data-parallel over its "data" axis, as JAX's GSPMD step is.  Each position
runs its rows of the global batch on its device, the positions in lockstep
(`core.lockstep`): train-mode BatchNorm takes the global batch's moments,
the augment decisions and C3D's dropout mask are the global batch's rows,
the gradients add up onto the one module, and one optimizer step runs, so
the update equals the unsharded step's.  A resident dataset is sharded over
the same mesh and each position gathers from its own rows.  With
`processes` the data axis continues in other processes
(`parallel.distributed.ProcessSum`).

`make_wire_train_step` (JAX engine.py:240-317) is fed by the ragged wire
(`data.wire_format`) instead of a dense or resident batch: the step
unpacks it, runs the windowed augment on the plan's decisions, then the
same body as `make_train_step`.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.lockstep import Lockstep, Shard, run_positions
from ..core.mesh import Mesh, split_positions
from ..data.pipeline import class_weights_balanced, iterate_batches
from ..data.resident import ResidentClips
from ..flow.farneback import gray_pair_flow
from ..models.common import l2_param_penalty
from ..models.registry import ModelBundle
from ..ops.augment import (
    AugmentDecisions,
    crowd11_augment_from_decisions,
    crowd11_augment_gray_pair_batch,
    crowd11_augment_windowed_from_decisions,
    draw_decisions,
    identity_resize_batch,
    step_generator,
)
from ..parallel.distributed import ProcessSum
from .callbacks import EarlyStopping, LRPolicy, lr_policy_for
from .checkpoints import best_exists, full_exists, restore_best, restore_full, save_best, save_full
from .state import OptimizerFactory, TrainState, make_optimizer, set_learning_rate

R3D_L2_WEIGHT = 1e-4  # Keras l2(1e-4) on every R3D kernel (train.py:1292)
_DROPOUT_STREAM = 1  # the dropout generator's seed word after (seed, step)


def _step_key(seed: int, step: int, *stream: int) -> int:
    return int(np.random.SeedSequence([seed, step, *stream]).generate_state(1, np.uint64)[0])



def _dropout_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The generator of one step's dropout masks, on the module's device,
    seeded by (seed, step, 1): a stream apart from the augment decisions, as
    JAX splits the step's key into rng_aug and rng_drop (engine.py:195-196)."""
    return torch.Generator(device=device).manual_seed(_step_key(seed, step, _DROPOUT_STREAM))


def train_policy(model_type: str, optimizer: Optional[OptimizerFactory] = None) -> Tuple[OptimizerFactory, float]:
    """(tx, l2 weight) of a family (JAX orchestration._step_policy,
    orchestration.py:336-350): `optimizer`, else the reference's optimizer
    at its LR policy's initial rate; R3D_L2_WEIGHT for the R3D family, 0
    for the others."""
    tx = optimizer or make_optimizer(model_type, lr_policy_for(model_type).initial_lr)
    return tx, (R3D_L2_WEIGHT if model_type.startswith("R3D") else 0.0)


def _preprocess(
    batch: Dict[str, torch.Tensor],
    decisions: Optional[AugmentDecisions],
    out_hw: Tuple[int, int],
    two_stream: bool,
    input_scale: float = 1.0,
    flow_fast_warp: bool = False,
    flow_params: Optional[dict] = None,
    flow_from_augmented: bool = False,
    clip_offset: int = 0,
    global_batch: Optional[int] = None,
    windowed: Optional[Tuple[Tuple[int, int], int]] = None,
) -> Dict[str, torch.Tensor]:
    """uint8 staged batch → float32 model inputs, on its device (JAX
    engine.py:40-120).  `decisions` augments the rgb (None: a plain
    resize).  input_scale=1.0 is the reference's raw 0-255 pixels
    (train.py:283-289); scratch training is steadier at 1/255.

    Two-stream models take precomputed flow, `batch['flow']`, resized and
    scaled like the rgb and never augmented (train.py:195-221), or gray
    pairs, `batch['gray']` and `batch['gray_next']` (B, T, H, W, 1), whose
    Farnebäck flow (`gray_pair_flow`: no input_scale) is computed here,
    without gradients.  With `flow_from_augmented` and decisions the pairs
    first take the rgb stream's crop and flip and salt/pepper of their own
    (the reference's augmented-Farnebäck mode, train.py:176-184); otherwise
    the flow is of the unaugmented pairs.  A data-parallel position passes
    its rows' decisions (`AugmentDecisions.rows`), its first row
    `clip_offset` and the `global_batch` size, and draws the noise of those
    rows of the global batch.  `windowed` = (staging_hw, crop_margin): the
    rgb is the wire's window buffer, augmented by the windowed policy."""
    rgb = batch["rgb"]
    if decisions is not None and windowed is not None:
        rgb = crowd11_augment_windowed_from_decisions(rgb, out_hw, windowed[0], decisions, windowed[1], clip_offset)
    elif decisions is not None:
        rgb = crowd11_augment_from_decisions(rgb, out_hw, decisions, clip_offset)
    else:
        rgb = identity_resize_batch(rgb, out_hw)
    out = {"rgb": rgb * input_scale}
    if not two_stream:
        return out
    if "flow" in batch:
        out["flow"] = identity_resize_batch(batch["flow"], out_hw) * input_scale
    elif "gray" in batch and "gray_next" in batch:
        gray, gray_next = batch["gray"], batch["gray_next"]
        with torch.no_grad():
            if decisions is not None and flow_from_augmented:
                if gray.shape[2:4] != batch["rgb"].shape[2:4]:
                    raise ValueError(f"augmented gray pairs must be staged as the rgb is: {tuple(gray.shape[2:4])} "
                                     f"against {tuple(batch['rgb'].shape[2:4])}")
                gray, gray_next = crowd11_augment_gray_pair_batch(gray, gray_next, decisions, clip_offset,
                                                                  global_batch)
            out["flow"] = gray_pair_flow(gray, gray_next, out_hw, flow_fast_warp, flow_params)
    else:
        raise ValueError("a two-stream model needs batch['flow'] or the gray pairs batch['gray'] and "
                         f"batch['gray_next']; the batch has {sorted(batch)}")
    return out


def _on_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


def _gather(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """A resident batch ({"resident", "indices", "valid"}) → the dense
    batch of its rows, gathered on the device."""
    indices = torch.as_tensor(batch["indices"]).to(device, non_blocking=True)
    dense = {k: v.index_select(0, indices) for k, v in batch["resident"].items()}
    dense["valid"] = torch.as_tensor(batch["valid"]).to(device, non_blocking=True)
    return dense


def _check_tx(state: TrainState, tx: OptimizerFactory) -> None:
    if state.tx is not tx:
        raise ValueError("the train state's optimizer was not made from this step's tx")


# ----------------------------------------------------------------------
# Data-parallel steps over a mesh (JAX engine.py:208-238, :320-460,
# :492-516).  JAX shards the batch over the mesh's data axis and GSPMD
# runs one program; here each position of the axis holds its rows on its
# device and runs the unsharded model code on them, the positions in
# lockstep on threads (`core.lockstep`), so that BatchNorm takes the
# global batch's moments and every draw is the global batch's.
# ----------------------------------------------------------------------


def _data_devices(bundle: ModelBundle, mesh: Mesh, data_axis: str) -> List[torch.device]:
    devices = mesh.axis_devices(data_axis)
    if bundle.device not in devices:
        raise ValueError(f"the module lies on {bundle.device}, which no position of the mesh's {data_axis!r} axis "
                         f"holds ({[str(d) for d in devices]})")
    return devices


class _Replicas:
    """The module on each device the positions hold: the bundle's own module
    on its device, a copy on any other card, refreshed from it before every
    step.  The copies' gradients are added onto the module's after the
    backward pass, so one optimizer step updates one parameter set."""

    def __init__(self, module: nn.Module, devices: Sequence[torch.device]):
        home = next(module.parameters()).device
        self.module = module
        self.copies = {d: copy.deepcopy(module).to(d) for d in dict.fromkeys(devices) if d != home}

    def on(self, device: torch.device) -> nn.Module:
        return self.copies.get(device, self.module)

    def refresh(self) -> None:
        if not self.copies:
            return
        state = self.module.state_dict()
        with torch.no_grad():
            for replica in self.copies.values():
                for k, v in replica.state_dict().items():
                    v.copy_(state[k])
                replica.train(self.module.training)

    def add_grads(self) -> None:
        for replica in self.copies.values():
            for p, q in zip(self.module.parameters(), replica.parameters()):
                if q.grad is not None:
                    g = q.grad.to(p.device)
                    p.grad = g if p.grad is None else p.grad + g
                    q.grad = None


def _split_batch(batch: Dict[str, Any], devices: Sequence[torch.device]) -> List[Dict[str, torch.Tensor]]:
    """A global dense batch → one dense batch a position, its rows on its
    device (JAX `with_sharding_constraint(v, P(data_axis))`)."""
    parts = {k: split_positions(torch.as_tensor(v), devices) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(len(devices))]


def _gather_shards(batch: Dict[str, Any], devices: Sequence[torch.device]) -> List[Dict[str, torch.Tensor]]:
    """A sharded resident batch → one dense batch a position, each gathered
    from that position's own resident rows by its block of the
    shard-block-major local indices (JAX `_make_resident_gather`,
    engine.py:320-365): no resident bytes cross positions."""
    n = len(devices)
    resident = batch["resident"]
    for k, v in resident.items():
        if not isinstance(v, (list, tuple)) or len(v) != n or any(t.device != d for t, d in zip(v, devices)):
            raise ValueError(f"resident {k!r} is not sharded over this step's {n} positions: build the "
                             "ResidentClips with the step's mesh")
    indices = torch.as_tensor(batch["indices"]).chunk(n)
    valid = torch.as_tensor(batch["valid"]).chunk(n)
    out = []
    for i, d in enumerate(devices):
        local = indices[i].to(d, non_blocking=True)
        dense = {k: v[i].index_select(0, local) for k, v in resident.items()}
        dense["valid"] = valid[i].to(d, non_blocking=True)
        out.append(dense)
    return out


def _make_train_body(
    bundle: ModelBundle,
    out_hw: Tuple[int, int],
    augment: bool,
    augment_p: float,
    l2_weight: float,
    input_scale: float,
    flow_fast_warp: bool = False,
    flow_params: Optional[dict] = None,
    flow_from_augmented: bool = False,
    weight_normalized: bool = False,
    *,
    mesh: Optional[Mesh] = None,
    data_axis: str = "data",
    processes: Optional[ProcessSum] = None,
    windowed: Optional[Tuple[Tuple[int, int], int]] = None,
):
    """The train body of every step: fn(state, parts, class_weights,
    decisions=None) with
    `parts` the batch's dense parts {"rgb" uint8 [+ "flow" | "gray",
    "gray_next"], "label", "valid"}, tensors on their devices: the whole
    batch on the module's device, or with a `mesh` one part a position of
    `data_axis`, on its device → (state, {"loss", "accuracy"} device
    scalars).  The loss is Keras's class_weight mean: Σ ce·mask·w[label] /
    max(Σ mask, 1) (JAX engine.py:123-172), or over max(Σ mask·w[label], 1)
    with `weight_normalized` (the JAX multi-member step's,
    multi_member.py:77), + l2 for R3D.

    - The augment decisions are drawn once for the global batch, from
      (state.seed, state.step), or given (the wire's, with `windowed` =
      (staging_hw, crop_margin) for its windowed policy); each part
      applies its rows of them, the
      noise kernel at its clip offset; TwoStream flow is computed from each
      part's rows.
    - `_rows_sums` runs the forward of one part.  Unsharded it runs inline
      (native BatchNorm); with a mesh it runs at every position at once
      (`core.lockstep`), BatchNorm taking the global moments and C3D's
      dropout the global mask's rows.
    - Then one loss over the summed parts, l2 once, one backward (the
      positions' gradients add up onto the module's parameters) and one
      optimizer step.  Metrics are global.

    `processes` (a `parallel.distributed.ProcessSum`, with a mesh): the data
    axis goes on in the other processes of its group, each holding its rows
    of the global batch (in rank order) on a mesh of its own; the BatchNorm
    sums, the normaliser, the metrics and the gradients are summed over
    them, so every process takes the same optimizer step."""
    if mesh is None and processes is not None:
        raise ValueError("processes= needs a mesh: the positions of this process")
    if mesh is not None:
        devices = _data_devices(bundle, mesh, data_axis)
        replicas = _Replicas(bundle.module, devices)
        master = devices.index(bundle.device)

    def rows_sums(module: nn.Module, batch, decisions, start: int, total: int, class_weights, generator):
        """(Σ ce·w, [Σ mask, Σ w, correct]) of one part's rows [start, start + rows)."""
        inputs = _preprocess(batch, decisions, out_hw, bundle.two_stream, input_scale, flow_fast_warp, flow_params,
                             flow_from_augmented, start, total, windowed)
        labels = batch["label"].long()
        mask = batch["valid"].float()
        weights = mask * class_weights.to(mask.device)[labels]
        logits = dataclasses.replace(bundle, module=module).apply(inputs, train=True, generator=generator)
        ce = F.cross_entropy(logits, labels, reduction="none")
        correct = ((logits.detach().argmax(-1) == labels) * mask).sum()
        return (ce * weights).sum(), torch.stack([mask.sum(), weights.sum(), correct])

    def train_step(state: TrainState, parts: Sequence[Dict[str, torch.Tensor]], class_weights,
                   decisions: Optional[AugmentDecisions] = None):
        rows = [int(part["label"].shape[0]) for part in parts]
        first, total = (0, sum(rows)) if processes is None else processes.row_span(sum(rows))
        if augment and decisions is None:
            _, _, h, w, _ = parts[0]["rgb"].shape
            decisions = draw_decisions(step_generator(state.seed, state.step), total, (h, w), augment_p)
        state.optimizer.zero_grad(set_to_none=True)
        if mesh is None:
            numerator, sums = rows_sums(bundle.module, parts[0], decisions, 0, total, class_weights,
                                        _dropout_generator(state.seed, state.step, bundle.device))
        else:
            bundle.module.train()
            replicas.refresh()
            starts = np.cumsum([first] + rows[:-1]).tolist()
            lockstep = Lockstep(len(devices), processes)

            def position(shard: Shard):
                mine = None if decisions is None else decisions.rows(shard.start, shard.start + shard.rows)
                return rows_sums(replicas.on(shard.device), parts[shard.position], mine, shard.start, total,
                                 class_weights, _dropout_generator(state.seed, state.step, shard.device))

            outs = run_positions(position, [Shard(i, d, starts[i], rows[i], total, lockstep, i == master)
                                            for i, d in enumerate(devices)])
            numerator = sum(o[0].to(bundle.device) for o in outs)
            sums = sum(o[1].to(bundle.device) for o in outs)
            if processes is not None:
                sums = processes.values(sums)
        mask_sum, weight_sum, correct = sums
        loss = numerator / (weight_sum if weight_normalized else mask_sum).clamp_min(1.0)
        if l2_weight > 0.0 and (processes is None or processes.rank == 0):
            loss = loss + l2_param_penalty(bundle.module, l2_weight)
        loss.backward()
        if mesh is not None:
            replicas.add_grads()
        loss = loss.detach()
        if processes is not None:
            processes.grads(bundle.module.parameters())
            loss = processes.values(loss)
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss, "accuracy": (correct / mask_sum.clamp_min(1.0)).float()}

    return train_step


def _make_eval_body(bundle: ModelBundle, out_hw: Tuple[int, int], input_scale: float,
                    flow_fast_warp: bool = False, flow_params: Optional[dict] = None, *, mesh: Optional[Mesh] = None,
                    data_axis: str = "data"):
    """The eval body of every eval step (JAX engine.py:459-489): fn(parts),
    the parts as `_make_train_body` takes them → the UNWEIGHTED masked loss
    sum, correct count and valid count over every part, and the softmax in
    part order, on the module's device.  Flow from gray pairs is of the
    unaugmented pairs.  Eval-mode BatchNorm reads the running statistics,
    so the positions of a mesh need no lockstep."""
    devices = [bundle.device] if mesh is None else _data_devices(bundle, mesh, data_axis)
    replicas = _Replicas(bundle.module, devices)

    def part_eval(module: nn.Module, batch):
        inputs = _preprocess(batch, None, out_hw, bundle.two_stream, input_scale, flow_fast_warp, flow_params)
        labels = batch["label"].long()
        mask = batch["valid"].float()
        logits = dataclasses.replace(bundle, module=module).apply(inputs, train=False)
        ce = F.cross_entropy(logits, labels, reduction="none")
        return {
            "loss_sum": (ce * mask).sum(),
            "correct": ((logits.argmax(-1) == labels) * mask).sum(),
            "count": mask.sum(),
            "probs": torch.softmax(logits, -1),
        }

    def eval_step(parts: Sequence[Dict[str, torch.Tensor]]):
        replicas.refresh()
        with torch.no_grad():
            outs = [part_eval(replicas.on(d), part) for d, part in zip(devices, parts)]
        if len(outs) == 1:
            return outs[0]
        home = bundle.device
        res = {k: sum(o[k].to(home) for o in outs) for k in ("loss_sum", "correct", "count")}
        res["probs"] = torch.cat([o["probs"].to(home) for o in outs])
        return res

    return eval_step


def _parts_of(bundle: ModelBundle, mesh: Optional[Mesh], data_axis: str, resident: bool):
    """fn(batch) → the dense parts the bodies take: the whole batch on the
    module's device, or one part a position of the mesh's `data_axis`; a
    resident batch gathered from its rows (with a mesh, each position from
    its own shard)."""
    if mesh is None:
        place = _gather if resident else _on_device
        return lambda batch: [place(batch, bundle.device)]
    devices = _data_devices(bundle, mesh, data_axis)
    split = _gather_shards if resident else _split_batch
    return lambda batch: split(batch, devices)


def make_train_step(
    bundle: ModelBundle,
    tx: OptimizerFactory,
    out_hw: Tuple[int, int],
    augment: bool,
    augment_p: float = 0.75,
    l2_weight: float = 0.0,
    input_scale: float = 1.0,
    flow_fast_warp: bool = False,
    flow_params: Optional[dict] = None,
    flow_from_augmented: bool = False,
    mesh: Optional[Mesh] = None,
    data_axis: str = "data",
    processes: Optional[ProcessSum] = None,
):
    """fn(state, batch, class_weights) → (state, metrics) over a dense batch
    {"rgb": (B, T, H, W, 3) uint8, "label": (B,), "valid": (B,) bool} (for
    TwoStream also "flow" (B, T, H, W, 2), or "gray" and "gray_next" (B, T,
    H, W, 1) from which Farnebäck computes the flow with `flow_params` and
    `flow_fast_warp`), tensors or numpy arrays.  `state` must come from
    `TrainState.create(bundle.module, tx, seed)`.

    With a `mesh` the batch is split over its `data_axis` (B must divide)
    and the step is data-parallel (JAX engine.py:208-238): every position
    runs its rows, BatchNorm takes the global batch's moments, and the
    update equals the unsharded step's on the same batch.  The module must
    lie on one of the axis's devices.  With `processes` (a
    `parallel.distributed.ProcessSum`) the batch is this process's rows of
    a global batch whose other rows the group's other processes hold, and
    every process takes the same step."""
    body = _make_train_body(bundle, out_hw, augment, augment_p, l2_weight, input_scale, flow_fast_warp, flow_params,
                            flow_from_augmented, mesh=mesh, data_axis=data_axis, processes=processes)
    parts = _parts_of(bundle, mesh, data_axis, resident=False)

    def train_step(state: TrainState, batch, class_weights):
        _check_tx(state, tx)
        return body(state, parts(batch), class_weights)

    return train_step


def make_wire_train_step(
    bundle: ModelBundle,
    tx: OptimizerFactory,
    plan,
    augment_key: Optional[int] = None,
    l2_weight: float = 0.0,
    mesh: Optional[Mesh] = None,
    data_axis: str = "data",
    input_scale: float = 1.0,
):
    """The wire-fed train step (JAX engine.py:240-317): fn(state, wire,
    offsets, step_idx, labels, valid, class_weights) → (state, metrics).

    The batch arrives as the ragged wire (`data.wire_format`): a
    `WirePlan`'s (cap,) u8 buffer, or with a `ShardedWirePlan` and a mesh
    the (n_shards, cap) rows, one a position of `data_axis`; a pinned host
    buffer (`pinned_wire`) is copied `non_blocking`.  The step unpacks it,
    runs the windowed augment on the plan's decisions of step `step_idx`,
    × input_scale, then the same loss and update body as `make_train_step`
    (with a mesh, its data-parallel form, each position unpacking its own
    wire row).  `augment_key`, when given, is the seed the plan was drawn
    from (`plan_wire_steps`), which is checked: a plan drawn from
    state.seed gives at step_idx = state.step the decisions
    `make_train_step` draws, so on the same pixels the two steps agree.
    Dropout masks come from (state.seed, state.step) as there.  RGB only:
    TwoStream's flow is of unaugmented frames, which the wire does not
    carry (JAX's reason)."""
    from ..data.wire_format import ShardedWirePlan, make_sharded_wire_unpack, make_wire_unpack

    if bundle.two_stream:
        raise ValueError("wire-fed training is RGB-only (see docstring)")
    if isinstance(plan, ShardedWirePlan):
        if mesh is None:
            raise ValueError("ShardedWirePlan requires a mesh")
        unpack, base = make_sharded_wire_unpack(plan, mesh, data_axis), plan.base
    else:
        if mesh is not None:
            raise ValueError("a wire-fed step over a mesh takes a ShardedWirePlan, one wire row a position")
        unpack, base = make_wire_unpack(plan), plan
    if augment_key is not None and base.seed is not None and base.seed != augment_key:
        raise ValueError(f"augment_key {augment_key} is not the seed the plan was drawn from ({base.seed})")
    body = _make_train_body(bundle, base.out_hw, True, base.p, l2_weight, input_scale, mesh=mesh,
                            data_axis=data_axis, windowed=(base.staging_hw, base.crop_margin))
    devices = [bundle.device] if mesh is None else _data_devices(bundle, mesh, data_axis)

    def train_step(state: TrainState, wire, offsets, step_idx: int, labels, valid, class_weights):
        _check_tx(state, tx)
        step_idx = int(step_idx)
        if mesh is None:
            windows = [unpack(torch.as_tensor(wire).to(bundle.device, non_blocking=True), offsets, step_idx)]
        else:
            windows = unpack(wire, offsets, step_idx)
        labels = split_positions(torch.as_tensor(labels), devices)
        valid = split_positions(torch.as_tensor(valid), devices)
        parts = [{"rgb": w, "label": lab, "valid": v} for w, lab, v in zip(windows, labels, valid)]
        return body(state, parts, class_weights, decisions=base.decisions[step_idx])

    return train_step


def make_resident_train_step(
    bundle: ModelBundle,
    tx: OptimizerFactory,
    out_hw: Tuple[int, int],
    augment: bool,
    augment_p: float = 0.75,
    l2_weight: float = 0.0,
    input_scale: float = 1.0,
    flow_fast_warp: bool = False,
    flow_params: Optional[dict] = None,
    flow_from_augmented: bool = False,
    mesh: Optional[Mesh] = None,
    data_axis: str = "data",
):
    """Train step over a device-resident dataset (`data.resident.ResidentClips`):
    fn(state, batch, class_weights) with batch = {"resident": {name → (N, …)
    device tensor, incl. "label"}, "indices": (B,) int32, "valid": (B,)
    bool}.  Each step gathers its rows on the device and runs the same body
    as `make_train_step`, so it equals that step on the gathered batch; the
    host ships only the indices and the mask.  Every input mode of the
    dense step works: rgb, precomputed flow, and gray pairs.

    With a `mesh`, the ResidentClips is sharded over the same mesh: each
    position gathers its block of the shard-block-major local indices from
    its own resident rows (JAX engine.py:320-419) and the step is
    `make_train_step(mesh=)`'s on the gathered rows."""
    body = _make_train_body(bundle, out_hw, augment, augment_p, l2_weight, input_scale, flow_fast_warp, flow_params,
                            flow_from_augmented, mesh=mesh, data_axis=data_axis)
    parts = _parts_of(bundle, mesh, data_axis, resident=True)

    def train_step(state: TrainState, batch, class_weights):
        _check_tx(state, tx)
        return body(state, parts(batch), class_weights)

    return train_step


def make_eval_step(bundle: ModelBundle, out_hw: Tuple[int, int], input_scale: float = 1.0,
                   flow_fast_warp: bool = False, flow_params: Optional[dict] = None, mesh: Optional[Mesh] = None,
                   data_axis: str = "data"):
    """fn(batch) → {"loss_sum", "correct", "count", "probs"} over a dense
    batch, with the module in eval mode and no gradients.  With a `mesh`
    the batch is split over its `data_axis` and each position evaluates
    its rows (JAX engine.py:492-516); the probabilities come back in batch
    order."""
    body = _make_eval_body(bundle, out_hw, input_scale, flow_fast_warp, flow_params, mesh=mesh, data_axis=data_axis)
    parts = _parts_of(bundle, mesh, data_axis, resident=False)
    return lambda batch: body(parts(batch))


def make_resident_eval_step(bundle: ModelBundle, out_hw: Tuple[int, int], input_scale: float = 1.0,
                            flow_fast_warp: bool = False, flow_params: Optional[dict] = None,
                            mesh: Optional[Mesh] = None, data_axis: str = "data"):
    """Eval twin of `make_resident_train_step`: the device-side gather, then
    the same body as `make_eval_step`; with a `mesh`, each position's gather
    from its own shard (JAX engine.py:421-460)."""
    body = _make_eval_body(bundle, out_hw, input_scale, flow_fast_warp, flow_params, mesh=mesh, data_axis=data_axis)
    parts = _parts_of(bundle, mesh, data_axis, resident=True)
    return lambda batch: body(parts(batch))


def _eval_step_for(bundle: ModelBundle, pipeline, out_hw, input_scale: float, flow_fast_warp: bool,
                   flow_params: Optional[dict], mesh: Optional[Mesh]):
    """The eval step `pipeline` takes: the resident one (over the
    ResidentClips's own mesh) or the dense one (over `mesh`)."""
    if isinstance(pipeline, ResidentClips):
        return make_resident_eval_step(bundle, out_hw, input_scale=input_scale, flow_fast_warp=flow_fast_warp,
                                       flow_params=flow_params, mesh=pipeline.mesh, data_axis=pipeline.data_axis)
    return make_eval_step(bundle, out_hw, input_scale=input_scale, flow_fast_warp=flow_fast_warp,
                          flow_params=flow_params, mesh=mesh)


def evaluate_model(
    bundle: ModelBundle,
    pipeline,
    out_hw: Tuple[int, int],
    collect_probs: bool = False,
    input_scale: float = 1.0,
    flow_fast_warp: bool = False,
    flow_params: Optional[dict] = None,
    eval_step=None,
    mesh: Optional[Mesh] = None,
) -> Dict[str, Any]:
    """Masked eval over epoch 0 of `pipeline` (reference evaluate(),
    train.py:1925-1971, batched): {"loss", "accuracy", "count"} and, with
    `collect_probs`, the valid rows' probabilities in clip-id order (a
    mesh-sharded ResidentClips yields its rows shard-interleaved, and they
    are put back in dataset order, JAX engine.py:560-566).  The module
    holds the weights, so no variables are passed.  The step is `eval_step`
    when given (one step shared across calls, JAX engine.py:518-536), else
    the resident one for a `ResidentClips` (over its mesh) and the dense
    one otherwise (over `mesh`); TwoStream gray pairs turn into flow with
    `flow_params` and `flow_fast_warp`."""
    if eval_step is None:
        eval_step = _eval_step_for(bundle, pipeline, out_hw, input_scale, flow_fast_warp, flow_params, mesh)
    sums = torch.zeros(3, dtype=torch.float64, device=bundle.device)  # loss_sum, correct, count
    probs_all, ids_all = [], []
    with iterate_batches(pipeline, 0) as batches:
        for batch in batches:
            out = eval_step(batch)
            sums += torch.stack([out["loss_sum"], out["correct"], out["count"]]).double()
            if collect_probs:
                valid = np.asarray(batch["valid"], bool)
                probs_all.append(out["probs"].float().cpu().numpy()[valid])
                if "index" in batch:
                    ids_all.append(np.asarray(batch["index"])[valid])
    loss_sum, correct, count = sums.tolist()
    res = {"loss": loss_sum / max(count, 1.0), "accuracy": correct / max(count, 1.0), "count": int(count)}
    if collect_probs:
        probs = np.concatenate(probs_all, axis=0)
        if ids_all and len(ids_all) == len(probs_all):
            probs = probs[np.argsort(np.concatenate(ids_all), kind="stable")]  # dataset order
        res["probs"] = probs
    return res


def fit(
    bundle: ModelBundle,
    train_pipeline,
    val_pipeline,
    *,
    epochs: int,
    seed: int = 0,
    augment: bool = False,
    augment_p: float = 0.75,
    balanced_classes: bool = False,
    checkpoint_dir: Optional[str] = None,
    lr_policy: Optional[LRPolicy] = None,
    early_stopping_patience: int = 100,
    initial_variables: Optional[Dict[str, torch.Tensor]] = None,
    verbose: bool = False,
    input_scale: float = 1.0,
    optimizer: Optional[OptimizerFactory] = None,
    metrics_logger=None,
    save_full_every: int = 0,
    resume_full: bool = False,
    flow_from_augmented: bool = False,
    flow_params: Optional[dict] = None,
    train_step=None,
    eval_step=None,
    mesh: Optional[Mesh] = None,
) -> Dict[str, Any]:
    """Epoch loop with the reference's callback semantics (JAX
    engine.py:569-744).  Trains `bundle` (a trainable one) in place from its
    current weights, or `initial_variables`; returns {'history': {...},
    'state': the final TrainState, 'best_val_loss': float}.

    - Warm resume: an existing best checkpoint in `checkpoint_dir` is loaded
      first (train.py:1887-1890); `resume_full` then restores the full
      state and the loop's metadata written every `save_full_every` epochs.
    - The steps are the resident ones for a `ResidentClips`, else the
      dense ones, with the family's optimizer and l2 rule (`train_policy`).
    - TwoStream gray pairs turn into flow with `flow_params`, in training
      from the augmented pairs with `flow_from_augmented`.
    - `mesh`, for a dense train pipeline: the steps are data-parallel over
      its "data" axis (`make_train_step(mesh=)`).  A ResidentClips brings
      the mesh it is sharded over (`ResidentClips(mesh=)`), and the steps
      are data-parallel over that one.
    - `train_step`/`eval_step`: steps built once and shared across fits
      (JAX engine.py:594-603), closing over this bundle; a train step must
      have been built with the same optimizer factory as `optimizer`."""
    out_hw = (bundle.clip.height, bundle.clip.width)
    policy = lr_policy or lr_policy_for(bundle.model_type)
    tx, l2w = train_policy(bundle.model_type, optimizer or make_optimizer(bundle.model_type, policy.initial_lr))
    if initial_variables is not None:
        bundle.module.load_state_dict(initial_variables)
    state = TrainState.create(bundle.module, tx, seed)
    if checkpoint_dir and best_exists(checkpoint_dir):
        restore_best(checkpoint_dir, bundle.module)

    if balanced_classes:
        labels = np.asarray(train_pipeline.df["class"], np.int64)
        cw = torch.as_tensor(class_weights_balanced(labels, bundle.num_classes), device=bundle.device)
    else:
        cw = torch.ones(bundle.num_classes, device=bundle.device)

    resident = isinstance(train_pipeline, ResidentClips)
    if resident:
        if mesh is not None:
            raise ValueError("a ResidentClips brings its own mesh (ResidentClips(mesh=)); fit's mesh= is for "
                             "dense pipelines")
        mesh = train_pipeline.mesh
    if train_step is None:
        make = make_resident_train_step if resident else make_train_step
        train_step = make(bundle, tx, out_hw, augment, augment_p, l2w, input_scale=input_scale,
                          flow_params=flow_params, flow_from_augmented=flow_from_augmented, mesh=mesh)
    if eval_step is None:  # one eval step for every epoch
        eval_step = _eval_step_for(bundle, val_pipeline, out_hw, input_scale, False, flow_params, mesh)
    early = EarlyStopping(patience=early_stopping_patience)
    history = {"loss": [], "accuracy": [], "val_loss": [], "val_accuracy": []}
    best_val = math.inf
    lr = policy.initial_lr
    start_epoch = 0

    # Exact resume: the full TrainState plus the loop's metadata.
    meta_path = os.path.join(checkpoint_dir, "fit_meta.json") if checkpoint_dir else None
    if resume_full and checkpoint_dir and full_exists(checkpoint_dir):
        state = restore_full(checkpoint_dir, state)
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            start_epoch = int(meta["epoch"]) + 1
            lr = float(meta["lr"])
            best_val = float(meta["best_val"])
            history = meta["history"]

    for epoch in range(start_epoch, epochs):
        lr = policy.epoch_begin_lr(epoch, lr)
        set_learning_rate(state.optimizer, lr)
        losses, accs = [], []
        with iterate_batches(train_pipeline, epoch) as batches:
            for batch in batches:
                state, metrics = train_step(state, batch, cw)
                losses.append(metrics["loss"])
                accs.append(metrics["accuracy"])
        epoch_loss = float(torch.stack(losses).mean())
        epoch_acc = float(torch.stack(accs).mean())

        if not math.isfinite(epoch_loss):  # TerminateOnNaN, actually wired
            history["loss"].append(epoch_loss)
            break

        val = evaluate_model(bundle, val_pipeline, out_hw, input_scale=input_scale, flow_params=flow_params,
                             eval_step=eval_step)
        history["loss"].append(epoch_loss)
        history["accuracy"].append(epoch_acc)
        history["val_loss"].append(val["loss"])
        history["val_accuracy"].append(val["accuracy"])
        if verbose:
            print(f"epoch {epoch}: loss {epoch_loss:.4f} acc {epoch_acc:.3f} "
                  f"val_loss {val['loss']:.4f} val_acc {val['accuracy']:.3f} lr {lr:.2e}")
        if metrics_logger is not None:
            metrics_logger.log("epoch", epoch=epoch, loss=epoch_loss, accuracy=epoch_acc, val_loss=val["loss"],
                               val_accuracy=val["accuracy"], lr=lr, model_type=bundle.model_type)

        if val["loss"] < best_val:  # best-only checkpoint (train.py:1850-1853)
            best_val = val["loss"]
            if checkpoint_dir:
                save_best(checkpoint_dir, state.variables())

        lr = policy.epoch_end_lr(val["loss"], lr)

        if save_full_every and checkpoint_dir and (epoch + 1) % save_full_every == 0:
            save_full(checkpoint_dir, state)
            with open(meta_path, "w") as f:
                json.dump({"epoch": epoch, "lr": lr, "best_val": best_val, "history": history}, f)

        if early.update(val["loss"]):
            break

    return {"history": history, "state": state, "best_val_loss": best_val}


def store_history(history: Dict, path: str) -> None:
    """Persist the val-loss history for VALIDATION_ERROR_INVERSE fusion
    (reference store_history, train.py:63-82, wrote `*_validation_losses.npy`)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.save(path, np.asarray(history["val_loss"], np.float32))

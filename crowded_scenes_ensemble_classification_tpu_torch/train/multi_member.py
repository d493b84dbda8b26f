"""Member-parallel training: the members of one architecture train together,
each on its own batch.

Counterpart of `crowded_scenes_ensemble_classification_tpu/train/multi_member.py`
(lines 31-128).  The reference trained its k·(k−1) members as independent
jobs (launch_train_ensemble.py:144-158); JAX stacks the members' states on a
leading axis and vmaps one update over them.  Here each member is a module
with its own `TrainState`, and one step runs the members one after another,
member m on its own (B, …) slice of the stacked (M, B, …) batch.  The JAX
members are independent, so the loop computes what the vmap does.

Why a loop and not `torch.func.vmap`: BatchNorm's running-statistic updates
are in-place writes to buffers, and the `csec::` custom ops (the max pool,
its gradient, the noise) have no vmap rule.

On a (member, data) mesh (`core.mesh`, JAX multi_member.py:104-118) the
members split over the member axis, group g taking members [g·M/G,
(g+1)·M/G), and each member's batch splits over its group's data
positions: its step is the data-parallel step (`train.engine`, BatchNorm
over the member's global batch) on those positions.  Members never
exchange anything, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.mesh import Mesh
from ..models.registry import ModelBundle
from .engine import _check_tx, _make_train_body, _on_device, _split_batch
from .state import OptimizerFactory, TrainState


def stack_states(states: Sequence[TrainState]) -> List[TrainState]:
    """The members' states as one stacked state: a list, member m at m."""
    return list(states)


def unstack_states(stacked: Sequence[TrainState], n: int) -> List[TrainState]:
    """The first n member states of a stacked state."""
    if n > len(stacked):
        raise ValueError(f"the stacked state holds {len(stacked)} members, not {n}")
    return list(stacked[:n])


def make_multi_member_train_step(
    bundle: ModelBundle,
    tx: OptimizerFactory,
    out_hw: Tuple[int, int],
    augment: bool,
    augment_p: float = 0.75,
    l2_weight: float = 0.0,
    input_scale: float = 1.0,
    mesh: Optional[Mesh] = None,
    member_axis: str = "member",
    data_axis: str = "data",
):
    """step(stacked_states, stacked_batch, class_weights) → (stacked_states,
    {"loss": (M,), "accuracy": (M,)}).  `bundle` gives the architecture; each
    state holds its member's module, made with `tx`.  stacked_batch leaves
    have a leading member dim: rgb (M, B, T, H, W, C), label (M, B), valid
    (M, B), tensors or numpy arrays.  Each member's update is the dense
    train step's, with its augment and dropout draws from its own (seed,
    step), and the loss normalised by Σ mask·w[label] as JAX's multi-member
    step does (multi_member.py:77), not by the valid count.

    With a `mesh`, member m trains data-parallel over the data positions of
    its member group (the member axis must divide M, the data axis B, and
    the member's module must lie on one of its group's devices); the
    metrics come back on the first member's device."""
    grid = None if mesh is None else mesh.grid(member_axis, data_axis)
    bodies = {}  # a member's data-parallel body, by its module

    def group_body(m: int, count: int, member: ModelBundle):
        groups = grid.shape[0]
        if count % groups:
            raise ValueError(f"{count} members do not divide over a {member_axis} axis of {groups}")
        row = grid[m // (count // groups)]
        devices = np.empty(len(row), dtype=object)
        devices[:] = list(row)
        key = id(member.module)
        if key not in bodies:
            bodies[key] = (_make_train_body(member, out_hw, augment, augment_p, l2_weight, input_scale,
                                            weight_normalized=True, mesh=Mesh(devices, ("data",))),
                           list(row))
        return bodies[key]

    def step(states: Sequence[TrainState], batch, class_weights):
        losses, accuracies = [], []
        for m, state in enumerate(states):
            _check_tx(state, tx)
            member = dataclasses.replace(bundle, module=state.module)
            rows = {k: v[m] for k, v in batch.items()}
            if grid is None:
                body = _make_train_body(member, out_hw, augment, augment_p, l2_weight, input_scale,
                                        weight_normalized=True)
                _, metrics = body(state, [_on_device(rows, member.device)], class_weights)
            else:
                body, devices = group_body(m, len(states), member)
                _, metrics = body(state, _split_batch(rows, devices), class_weights)
            home = losses[0].device if losses else metrics["loss"].device
            losses.append(metrics["loss"].to(home))
            accuracies.append(metrics["accuracy"].to(home))
        return list(states), {"loss": torch.stack(losses), "accuracy": torch.stack(accuracies)}

    return step


def zip_member_batches(batch_iters) -> Iterator[dict]:
    """Zip per-member batch iterators into stacked (M, B, ...) numpy batches
    of the keys every member's batch has.  Stops at the shortest member
    epoch (members have equal-length train splits in the k-fold design)."""
    for batches in zip(*batch_iters):
        keys = set.intersection(*(set(b) for b in batches))
        yield {k: np.stack([np.asarray(b[k]) for b in batches]) for k in keys}

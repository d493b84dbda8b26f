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

The member-sharded mesh form, which puts members on different devices,
is part 2 of the port's distribution (ROADMAP Queue 1 item 9); the mesh
itself is `core.mesh`.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from ..models.registry import ModelBundle
from .engine import _check_tx, _make_dense_train_body, _on_device
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
):
    """step(stacked_states, stacked_batch, class_weights) → (stacked_states,
    {"loss": (M,), "accuracy": (M,)}).  `bundle` gives the architecture; each
    state holds its member's module, made with `tx`.  stacked_batch leaves
    have a leading member dim: rgb (M, B, T, H, W, C), label (M, B), valid
    (M, B), tensors or numpy arrays.  Each member's update is the dense
    train step's, with its augment and dropout draws from its own (seed,
    step), and the loss normalised by Σ mask·w[label] as JAX's multi-member
    step does (multi_member.py:77), not by the valid count."""

    def step(states: Sequence[TrainState], batch, class_weights):
        losses, accuracies = [], []
        for m, state in enumerate(states):
            _check_tx(state, tx)
            member = dataclasses.replace(bundle, module=state.module)
            body = _make_dense_train_body(member, out_hw, augment, augment_p, l2_weight, input_scale,
                                          weight_normalized=True)
            _, metrics = body(state, _on_device({k: v[m] for k, v in batch.items()}, member.device), class_weights)
            losses.append(metrics["loss"])
            accuracies.append(metrics["accuracy"])
        return list(states), {"loss": torch.stack(losses), "accuracy": torch.stack(accuracies)}

    return step


def zip_member_batches(batch_iters) -> Iterator[dict]:
    """Zip per-member batch iterators into stacked (M, B, ...) numpy batches
    of the keys every member's batch has.  Stops at the shortest member
    epoch (members have equal-length train splits in the k-fold design)."""
    for batches in zip(*batch_iters):
        keys = set.intersection(*(set(b) for b in batches))
        yield {k: np.stack([np.asarray(b[k]) for b in batches]) for k in keys}

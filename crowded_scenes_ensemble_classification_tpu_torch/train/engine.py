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
and the resident steps, or any other object with `batches(epoch)`.  Not
ported: the wire-fed step (a TPU transfer workaround, left out: ROADMAP
Queue 1 item 8) and data-parallel training over the mesh (item 9).
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..data.pipeline import class_weights_balanced, iterate_batches
from ..data.resident import ResidentClips
from ..flow.farneback import gray_pair_flow
from ..models.common import l2_param_penalty
from ..models.registry import ModelBundle
from ..ops.augment import (
    AugmentDecisions,
    crowd11_augment_from_decisions,
    crowd11_augment_gray_pair_batch,
    draw_decisions,
    identity_resize_batch,
)
from .callbacks import EarlyStopping, LRPolicy, lr_policy_for
from .checkpoints import best_exists, full_exists, restore_best, restore_full, save_best, save_full
from .state import OptimizerFactory, TrainState, make_optimizer, set_learning_rate

R3D_L2_WEIGHT = 1e-4  # Keras l2(1e-4) on every R3D kernel (train.py:1292)
_DROPOUT_STREAM = 1  # the dropout generator's seed word after (seed, step)


def _step_key(seed: int, step: int, *stream: int) -> int:
    return int(np.random.SeedSequence([seed, step, *stream]).generate_state(1, np.uint64)[0])


def _augment_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of one step's augment decisions, seeded by
    (seed, step)."""
    return torch.Generator().manual_seed(_step_key(seed, step))


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
    the flow is of the unaugmented pairs."""
    rgb = batch["rgb"]
    if decisions is not None:
        rgb = crowd11_augment_from_decisions(rgb, out_hw, decisions)
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
                gray, gray_next = crowd11_augment_gray_pair_batch(gray, gray_next, decisions)
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


def _make_dense_train_body(
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
):
    """The train body of every step: fn(state, batch, class_weights) with
    batch = {"rgb" uint8 [+ "flow" | "gray", "gray_next"], "label",
    "valid"} tensors on the module's device → (state, {"loss",
    "accuracy"} device scalars).  The loss is Keras's class_weight mean:
    Σ ce·mask·w[label] / max(Σ mask, 1) (JAX engine.py:123-172), or over
    max(Σ mask·w[label], 1) with `weight_normalized` (the JAX multi-member
    step's, multi_member.py:77), + l2 for R3D."""
    module = bundle.module

    def train_step(state: TrainState, batch, class_weights):
        decisions = None
        if augment:
            b, _, h, w, _ = batch["rgb"].shape
            decisions = draw_decisions(_augment_generator(state.seed, state.step), b, (h, w), augment_p)
        inputs = _preprocess(batch, decisions, out_hw, bundle.two_stream, input_scale, flow_fast_warp, flow_params,
                             flow_from_augmented)
        labels = batch["label"].long()
        mask = batch["valid"].float()
        weights = mask * class_weights[labels]
        count = (weights.sum() if weight_normalized else mask.sum()).clamp_min(1.0)
        state.optimizer.zero_grad(set_to_none=True)
        logits = bundle.apply(inputs, train=True, generator=_dropout_generator(state.seed, state.step, bundle.device))
        ce = F.cross_entropy(logits, labels, reduction="none")
        loss = (ce * weights).sum() / count
        if l2_weight > 0.0:
            loss = loss + l2_param_penalty(module, l2_weight)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        accuracy = ((logits.detach().argmax(-1) == labels) * mask).sum() / mask.sum().clamp_min(1.0)
        return state, {"loss": loss.detach(), "accuracy": accuracy}

    return train_step


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
):
    """fn(state, batch, class_weights) → (state, metrics) over a dense batch
    {"rgb": (B, T, H, W, 3) uint8, "label": (B,), "valid": (B,) bool} (for
    TwoStream also "flow" (B, T, H, W, 2), or "gray" and "gray_next" (B, T,
    H, W, 1) from which Farnebäck computes the flow with `flow_params` and
    `flow_fast_warp`), tensors or numpy arrays.  `state` must come from
    `TrainState.create(bundle.module, tx, seed)`."""
    body = _make_dense_train_body(bundle, out_hw, augment, augment_p, l2_weight, input_scale, flow_fast_warp,
                                  flow_params, flow_from_augmented)

    def train_step(state: TrainState, batch, class_weights):
        _check_tx(state, tx)
        return body(state, _on_device(batch, bundle.device), class_weights)

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
):
    """Train step over a device-resident dataset (`data.resident.ResidentClips`):
    fn(state, batch, class_weights) with batch = {"resident": {name → (N, …)
    device tensor, incl. "label"}, "indices": (B,) int32, "valid": (B,)
    bool}.  Each step gathers its rows on the device and runs the same body
    as `make_train_step`, so it equals that step on the gathered batch; the
    host ships only the indices and the mask.  Every input mode of the
    dense step works: rgb, precomputed flow, and gray pairs."""
    body = _make_dense_train_body(bundle, out_hw, augment, augment_p, l2_weight, input_scale, flow_fast_warp,
                                  flow_params, flow_from_augmented)

    def train_step(state: TrainState, batch, class_weights):
        _check_tx(state, tx)
        return body(state, _gather(batch, bundle.device), class_weights)

    return train_step


def _make_dense_eval_body(bundle: ModelBundle, out_hw: Tuple[int, int], input_scale: float,
                          flow_fast_warp: bool = False, flow_params: Optional[dict] = None):
    """The eval body of both eval steps (JAX engine.py:459-489): the
    UNWEIGHTED masked loss sum, correct count, valid count and softmax.
    Flow from gray pairs is of the unaugmented pairs."""

    def eval_step(batch):
        with torch.no_grad():
            inputs = _preprocess(batch, None, out_hw, bundle.two_stream, input_scale, flow_fast_warp, flow_params)
            labels = batch["label"].long()
            mask = batch["valid"].float()
            logits = bundle.apply(inputs, train=False)
            ce = F.cross_entropy(logits, labels, reduction="none")
            return {
                "loss_sum": (ce * mask).sum(),
                "correct": ((logits.argmax(-1) == labels) * mask).sum(),
                "count": mask.sum(),
                "probs": torch.softmax(logits, -1),
            }

    return eval_step


def make_eval_step(bundle: ModelBundle, out_hw: Tuple[int, int], input_scale: float = 1.0,
                   flow_fast_warp: bool = False, flow_params: Optional[dict] = None):
    """fn(batch) → {"loss_sum", "correct", "count", "probs"} over a dense
    batch, with the module in eval mode and no gradients."""
    body = _make_dense_eval_body(bundle, out_hw, input_scale, flow_fast_warp, flow_params)
    return lambda batch: body(_on_device(batch, bundle.device))


def make_resident_eval_step(bundle: ModelBundle, out_hw: Tuple[int, int], input_scale: float = 1.0,
                            flow_fast_warp: bool = False, flow_params: Optional[dict] = None):
    """Eval twin of `make_resident_train_step`: the device-side gather, then
    the same body as `make_eval_step`."""
    body = _make_dense_eval_body(bundle, out_hw, input_scale, flow_fast_warp, flow_params)
    return lambda batch: body(_gather(batch, bundle.device))


def evaluate_model(
    bundle: ModelBundle,
    pipeline,
    out_hw: Tuple[int, int],
    collect_probs: bool = False,
    input_scale: float = 1.0,
    flow_fast_warp: bool = False,
    flow_params: Optional[dict] = None,
    eval_step=None,
) -> Dict[str, Any]:
    """Masked eval over epoch 0 of `pipeline` (reference evaluate(),
    train.py:1925-1971, batched): {"loss", "accuracy", "count"} and, with
    `collect_probs`, the valid rows' probabilities in clip-id order.  The
    module holds the weights, so no variables are passed.  The step is
    `eval_step` when given (one step shared across calls, JAX
    engine.py:518-536), else the resident one for a `ResidentClips` and
    the dense one otherwise; TwoStream gray pairs turn into flow with
    `flow_params` and `flow_fast_warp`."""
    if eval_step is None:
        make = make_resident_eval_step if isinstance(pipeline, ResidentClips) else make_eval_step
        eval_step = make(bundle, out_hw, input_scale=input_scale, flow_fast_warp=flow_fast_warp,
                         flow_params=flow_params)
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

    if train_step is None:
        make = make_resident_train_step if isinstance(train_pipeline, ResidentClips) else make_train_step
        train_step = make(bundle, tx, out_hw, augment, augment_p, l2w, input_scale=input_scale,
                          flow_params=flow_params, flow_from_augmented=flow_from_augmented)
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

"""Member training: the step of `train.make_resident_train_step(augment=True)`
over device-resident uint8 clips (gather on the device, the Crowd-11
augment with the noise kernel, × input_scale, the forward in bf16 on f32
master weights with BatchNorm on batch statistics, class-weighted
cross-entropy, the backward through the max-pool gradient kernel, Keras
SGD with momentum), steps back to back.

Set-up makes the weights and the clips from the seed, builds one trainable
I3D and its optimizer, and drives that same state through the first
`checked_steps` steps by the window's own call and feed (rows that all
differ): they warm every shape, and what they leave is read for the check
(each step's loss, the first gradient from the optimizer's velocity, the
parameters' change over the steps).  The window continues from there.  The
check runs the reference's float32 steps on the same rows and decisions.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import check, loops, traffic, weights
from ..reference import frontend, nets
from ..reference import train as ref_train

WEIGHT_STREAM, STATE_STREAM, FEED_STREAM = 1, 5, 6
FAMILY = "I3D"


class Feed:
    """Batches of the resident rows: a fresh permutation of all rows each
    epoch, from the seed; every batch full and valid."""

    def __init__(self, data: dict, batch: int, seed: int):
        self.data, self.batch = data, batch
        self.rng = np.random.default_rng(seed)
        self.order, self.at = np.empty(0, np.int64), 0

    def next(self) -> dict:
        if self.at + self.batch > len(self.order):
            self.order, self.at = self.rng.permutation(self.data["label"].shape[0]), 0
        idx = self.order[self.at:self.at + self.batch]
        self.at += self.batch
        return {"resident": self.data, "indices": idx, "valid": np.ones(self.batch, bool)}


class Entry:
    def __init__(self, ctx):
        from crowded_scenes_ensemble_classification_tpu_torch.models import build_model
        from crowded_scenes_ensemble_classification_tpu_torch.train import (
            TrainState,
            make_optimizer,
            make_resident_train_step,
        )

        self.ctx, cfg, tr, dev = ctx, ctx.config, ctx.traffic, ctx.device
        train = cfg["train"]
        specs = nets.family_specs(FAMILY, cfg)
        params = weights.make_member(specs, weights.sub_seed(ctx.seed, WEIGHT_STREAM, 0), dev, train["weight_dtype"],
                                     {"": cfg["input_rms"]["rgb"] * train["input_scale"]})
        bundle = build_model(FAMILY, num_classes=cfg["classes"], dtype=weights.DTYPES[train["compute_dtype"]], device=dev,
                             generator=torch.Generator(device=dev).manual_seed(0), trainable=True)
        weights.load_into(bundle.module, params, scale_free_bn=True)
        self.params0 = weights.to_host(params)
        del params
        self.tx = make_optimizer(FAMILY, train["lr"])
        self.state_seed = weights.sub_seed(ctx.seed, STATE_STREAM)
        self.state = TrainState.create(bundle.module, self.tx, seed=self.state_seed)
        self.step_fn = make_resident_train_step(bundle, self.tx, tuple(train["out_hw"]), augment=True,
                                                augment_p=tr["augment_p"], input_scale=train["input_scale"])
        self.class_weights = torch.as_tensor(train["class_weights"], dtype=torch.float32, device=dev)
        self.data = traffic.make(tr, ctx.seed, dev)
        self.feed = Feed(self.data, tr["batch"], weights.sub_seed(ctx.seed, FEED_STREAM))
        self.first = self._first_steps(bundle.module, tr["checked_steps"])
        loops.sync(dev)

    def _step(self) -> torch.Tensor:
        self.state, metrics = self.step_fn(self.state, self._batch(), self.class_weights)
        return metrics["loss"]

    def _batch(self) -> dict:
        batch = self.feed.next()
        self.fed.append(batch["indices"])
        return batch

    def _first_steps(self, module, n: int) -> dict:
        """Run the first n steps; keep each loss, the first gradient's norm
        by leaf (‖velocity‖/lr after step 1) and the change's by leaf."""
        named = [(k, p) for k, p in module.named_parameters() if p.requires_grad]
        p0 = {k: p.detach().clone() for k, p in named}
        self.fed, out = [], {"loss": [], "grad": {}}
        lr = self.ctx.config["train"]["lr"]
        for i in range(n):
            out["loss"].append(float(self._step()))
            if i == 0:
                opt = self.state.optimizer
                velocity = {k: opt.state[p].get("velocity") for k, p in named}  # none: no step was taken
                out["grad"] = {k: 0.0 if v is None else float(v.double().norm()) / lr for k, v in velocity.items()}
        out["delta"] = {k: float((p.detach().double() - p0[k].double()).norm()) for k, p in named}
        out["indices"] = list(self.fed)
        return out

    def window(self, seconds: float, tracing) -> dict:
        record = loops.train_window(self._step, seconds, self.ctx.device, tracing)
        record["clips_per_step"] = self.ctx.traffic["batch"]
        return record

    def release(self) -> None:
        del self.state, self.step_fn

    def check(self, record: dict) -> dict:
        ctx, tr, train = self.ctx, self.ctx.traffic, self.ctx.config["train"]
        failed = sum(int(not torch.isfinite(loss).all()) for loss in record["losses"])
        steps = []
        for i, idx in enumerate(self.first["indices"]):
            index = torch.as_tensor(idx, device=self.data["rgb"].device)
            steps.append({"rgb": self.data["rgb"][index], "label": self.data["label"][index],
                          "valid": torch.ones(len(idx), dtype=torch.bool),
                          "decisions": frontend.draw_decisions(frontend.step_generator(self.state_seed, i), len(idx),
                                                               (tr["staging"],) * 2, tr["augment_p"])})
        ref = ref_train.train_steps(self.params0, steps, ctx.config, nets.EXACT, ctx.device)
        prog = ref_train.train_steps(self.params0, steps, ctx.config, nets.Precision(ctx.control), ctx.device) \
            if ctx.control else self.first
        leaves = ref_train.moved_leaves(ref["grad"])
        readings = {"loss_err": check.relative_gaps(prog["loss"], ref["loss"]),
                    "grad_err": ref_train.worst_leaf_gap(prog["grad"], ref["grad"], leaves),
                    "update_err": ref_train.worst_leaf_gap(prog["delta"], ref["delta"], leaves),
                    "loss1_err": check.relative_gaps(prog["loss"][:1], ref["loss"][:1]),
                    "grad_med_err": ref_train.median_leaf_gap(prog["grad"], ref["grad"], leaves),
                    "update_med_err": ref_train.median_leaf_gap(prog["delta"], ref["delta"], leaves)}
        return {"readings": readings, "failed": failed}

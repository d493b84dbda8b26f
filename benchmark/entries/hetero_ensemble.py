"""The global heterogeneous ensemble: `ensemble.pipeline.hetero_ensemble_step`
over resident 224² clips and their stored flow (one shared s2d staging of
each for I3D and TwoStream, the 16×112² subsample for C3D and R3D, every
family's members in turn, softmax, SUM fusion), two batches in flight.

Set-up makes every member's weights, the clips and the flow fields from
the seed (the flow stands for an offline store, as the reference reads
precomputed flow), builds the members in bf16 and warms the step up.  The
check runs each family's reference on a sample of the answered clips.
"""

from __future__ import annotations

import torch

from .. import check, loops, traffic, weights
from ..reference import nets

WEIGHT_STREAM = 1
CHECK_BLOCK = 8
SHARED_STAGING = ("I3D", "TWOSTREAM_I3D")


class Entry:
    def __init__(self, ctx):
        from crowded_scenes_ensemble_classification_tpu_torch.ensemble.pipeline import hetero_ensemble_step
        from crowded_scenes_ensemble_classification_tpu_torch.models import build_model

        self.ctx, cfg, tr, dev = ctx, ctx.config, ctx.traffic, ctx.device
        self.step_fn = hetero_ensemble_step
        self.batch = tr["batch"]
        self.families, self.params = {}, {}
        index = 0
        for family, count in cfg["members"].items():
            specs = nets.family_specs(family, cfg)
            rms = {"": cfg["input_rms"]["rgb"], "rgb_trunk.": cfg["input_rms"]["rgb"],
                   "flow_trunk.": cfg["input_rms"]["flow"]}
            kwargs = {"stem_prestaged": True} if family in SHARED_STAGING else {}
            self.families[family], self.params[family] = [], []
            for _ in range(count):
                p = weights.make_member(specs, weights.sub_seed(ctx.seed, WEIGHT_STREAM, index), dev,
                                        cfg["weight_dtype"], rms)
                index += 1
                bundle = build_model(family, num_classes=cfg["classes"], dtype=weights.DTYPES[cfg["compute_dtype"]], device=dev,
                                     generator=torch.Generator(device=dev).manual_seed(0), **kwargs)
                weights.load_into(bundle.module, p, scale_free_bn=family in SHARED_STAGING)
                self.families[family].append(bundle.module)
                self.params[family].append(weights.to_host(p))
        self.data = traffic.make(tr, ctx.seed, dev)
        self.n_batches = self.data["rgb"].shape[0] // self.batch
        for k in range(tr["warm_steps"]):
            self._step(k)
        loops.sync(dev)

    def _rows(self, k: int) -> slice:
        start = (k % self.n_batches) * self.batch
        return slice(start, start + self.batch)

    def _step(self, k: int):
        rows = self._rows(k)
        return self.step_fn(self.families, self.data["rgb"][rows], self.data["flow"][rows])

    def window(self, seconds: float, tracing) -> dict:
        record = loops.probs_window(self._step, seconds, self.ctx.device, tracing,
                                    self.ctx.traffic["in_flight"])
        record["clips_per_batch"] = self.batch
        return record

    def release(self) -> None:
        del self.families, self.step_fn

    def check(self, record: dict) -> dict:
        ctx, tr = self.ctx, self.ctx.traffic
        done = record["batches"]
        failed = sum(check.answers_failed(b["probs"]) for b in done)
        picks = check.sample_clips(ctx.seed, len(done), self.batch, tr["check_clips"])
        index = torch.tensor([(done[i]["k"] % self.n_batches) * self.batch + r for i, r in picks],
                             device=self.data["rgb"].device)
        inputs = {"rgb": self.data["rgb"][index], "flow": self.data["flow"][index]}
        ref = self.reference_probs(inputs, None)
        if ctx.control:
            probs = self.reference_probs(inputs, ctx.control)
            preds = probs.sum(dim=1).argmax(dim=1)
        else:
            probs = torch.stack([done[i]["probs"][:, r] for i, r in picks])
            preds = torch.stack([done[i]["preds"][r] for i, r in picks])
        return {"readings": check.probs_readings(probs, preds, ref), "failed": failed}

    def reference_probs(self, inputs, mode) -> torch.Tensor:
        """(n, M, C) reference softmax of every member in the order the step
        runs them, in blocks of clips; `mode` the control's precision."""
        out, n = [], inputs["rgb"].shape[0]
        for family, members in self.params.items():
            for p in members:
                pd = weights.to_device(p, self.ctx.device)
                prec = nets.Precision(mode)
                with torch.no_grad():
                    out.append(torch.cat([
                        torch.softmax(nets.family_logits(family, pd, {k: v[i:i + CHECK_BLOCK] for k, v in inputs.items()},
                                                         self.ctx.config, prec), -1)
                        for i in range(0, n, CHECK_BLOCK)]).cpu())
                del pd
        return torch.stack(out, dim=1)

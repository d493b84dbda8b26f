"""The main path: `ensemble.pipeline.resident_ensemble_step` over resident
I420 rows (decode, the Crowd-11 augment with the noise kernel, one cast,
one shared s2d staging, the I3D members, softmax, SUM fusion), two batches
in flight.

Set-up makes the members' weights and the rows from the seed, builds the
members (bf16, or static int8 calibrated by `calibrate_members` on the
first batches of the rows when the configuration says so) and warms the
step up.  The window draws each batch's augment decisions from a CPU
generator seeded from the run's seed.  The check replays those draws,
decodes and augments the sampled clips again and runs the reference I3D
on them in float32.
"""

from __future__ import annotations

import torch

from .. import check, loops, traffic, weights
from ..reference import frontend, nets

WEIGHT_STREAM, DECISION_STREAM, WARM_STREAM, CALIBRATION_STREAM = 1, 2, 3, 4
FAMILY = "I3D"
CHECK_BLOCK = 8


class Entry:
    def __init__(self, ctx):
        from crowded_scenes_ensemble_classification_tpu_torch.ensemble.members import calibrate_members
        from crowded_scenes_ensemble_classification_tpu_torch.ensemble.pipeline import resident_ensemble_step
        from crowded_scenes_ensemble_classification_tpu_torch.models import build_model

        self.ctx, cfg, tr, dev = ctx, ctx.config, ctx.traffic, ctx.device
        self.step_fn = resident_ensemble_step
        self.batch, self.staging, self.frames = tr["batch"], tr["staging"], cfg["frames"]
        self.out_hw = (cfg["size"], cfg["size"])
        specs = nets.family_specs(FAMILY, cfg)
        rms = {"": cfg["input_rms"]["rgb"]}
        params = [weights.make_member(specs, weights.sub_seed(ctx.seed, WEIGHT_STREAM, i), dev, cfg["weight_dtype"],
                                      rms) for i in range(cfg["members"][FAMILY])]
        quant = "calib" if cfg["precision"] == "int8" else False
        self.members = []
        for p in params:
            bundle = build_model(FAMILY, num_classes=cfg["classes"], dtype=weights.DTYPES[cfg["compute_dtype"]], device=dev,
                                 generator=torch.Generator(device=dev).manual_seed(0), stem_prestaged=True,
                                 quant=quant)
            weights.load_into(bundle.module, p, scale_free_bn=True)
            self.members.append(bundle.module)
        self.params = [weights.to_host(p) for p in params]
        del params
        self.data = traffic.make(tr, ctx.seed, dev)["i420"]
        if quant:
            calibrate_members(self.members, self._calibration_batches(), self.out_hw, num_batches=cfg["calibration_batches"])
        warm = torch.Generator().manual_seed(weights.sub_seed(ctx.seed, WARM_STREAM))
        for k in range(tr["warm_steps"]):
            self._step(k, warm)
        loops.sync(dev)

    def _calibration_batches(self):
        """The first batches of the rows, decoded and augmented by the
        program's own functions, as `calibrate_members` takes them."""
        from crowded_scenes_ensemble_classification_tpu_torch.data.wire_format import i420_to_bgr_u8
        from crowded_scenes_ensemble_classification_tpu_torch.ops.augment import crowd11_augment_batch

        gen = torch.Generator().manual_seed(weights.sub_seed(self.ctx.seed, CALIBRATION_STREAM))
        for i in range(self.ctx.config["calibration_batches"]):
            rows = self.data[i * self.batch:(i + 1) * self.batch]
            clips = i420_to_bgr_u8(rows, self.frames, self.staging, self.staging)
            yield {"rgb": crowd11_augment_batch(clips, self.out_hw, self.ctx.traffic["augment_p"], gen)}

    def _step(self, k: int, gen: torch.Generator):
        return self.step_fn(self.members, self.data, k, gen, batch_size=self.batch, frames=self.frames,
                            staging=self.staging, out_hw=self.out_hw)

    def window(self, seconds: float, tracing) -> dict:
        gen = torch.Generator().manual_seed(weights.sub_seed(self.ctx.seed, DECISION_STREAM))
        record = loops.probs_window(lambda k: self._step(k, gen), seconds, self.ctx.device, tracing,
                                    self.ctx.traffic["in_flight"])
        record["clips_per_batch"] = self.batch
        return record

    def release(self) -> None:
        del self.members, self.step_fn

    def check(self, record: dict) -> dict:
        """Sample the answered clips, compute the reference's probabilities
        for them (or, as the control, the reference in a lower precision in
        the program's place) → {"readings", "failed"}."""
        ctx, cfg, tr = self.ctx, self.ctx.config, self.ctx.traffic
        done = record["batches"]
        failed = sum(check.answers_failed(b["probs"]) for b in done)
        picks = check.sample_clips(ctx.seed, len(done), self.batch, tr["check_clips"])
        gen = torch.Generator().manual_seed(weights.sub_seed(ctx.seed, DECISION_STREAM))
        decisions = [frontend.draw_decisions(gen, self.batch, (self.staging,) * 2, tr["augment_p"])
                     for _ in range(done[-1]["k"] + 1)]
        clips = torch.stack([self._reference_clip(done[i]["k"], r, decisions) for i, r in picks])
        ref = self.reference_probs(clips, [nets.EXACT] * len(self.params))
        if ctx.control:
            probs = self.reference_probs(clips, self._control_precisions())
            preds = probs.sum(dim=1).argmax(dim=1)
        else:
            probs = torch.stack([done[i]["probs"][:, r] for i, r in picks])
            preds = torch.stack([done[i]["preds"][r] for i, r in picks])
        return {"readings": check.probs_readings(probs, preds, ref), "failed": failed}

    def _reference_clip(self, k: int, row: int, decisions) -> torch.Tensor:
        n_batches = self.data.shape[0] // self.batch
        flat = self.data[(k % n_batches) * self.batch + row][None]
        clip = frontend.i420_to_bgr(flat, self.frames, self.staging, self.staging)
        return frontend.augment(clip, self.out_hw, frontend.select(decisions[k], [row]), torch.tensor([row]))[0]

    def reference_probs(self, clips: torch.Tensor, precs) -> torch.Tensor:
        """(n, T, H, W, 3) float32 clips → (n, M, C) reference softmax, in
        blocks of clips, one member's weights on the card at a time, member
        m computing in `precs[m]`."""
        out = []
        for p, prec in zip(self.params, precs):
            pd = weights.to_device(p, self.ctx.device)
            with torch.no_grad():
                out.append(torch.cat([torch.softmax(nets.i3d_logits(pd, clips[i:i + CHECK_BLOCK], self.ctx.config["sizes"][FAMILY], prec), -1)
                                      for i in range(0, len(clips), CHECK_BLOCK)]).cpu())
            del pd
        return torch.stack(out, dim=1)

    def _control_precisions(self) -> list:
        """The control's precision of each member; int4 scales come from the
        reference's own calibration on the batches the program calibrates on."""
        precs = [nets.Precision(self.ctx.control) for _ in self.params]
        if self.ctx.control == "int4":
            for prec in precs:
                prec.calibrating = True
            gen = torch.Generator().manual_seed(weights.sub_seed(self.ctx.seed, CALIBRATION_STREAM))
            for i in range(self.ctx.config["calibration_batches"]):
                rows = self.data[i * self.batch:(i + 1) * self.batch]
                d = frontend.draw_decisions(gen, self.batch, (self.staging,) * 2, self.ctx.traffic["augment_p"])
                clips = frontend.augment(frontend.i420_to_bgr(rows, self.frames, self.staging, self.staging),
                                         self.out_hw, d, torch.arange(self.batch))
                self.reference_probs(clips, precs)
            for prec in precs:
                prec.calibrating = False
        return precs

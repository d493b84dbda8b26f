"""The comparison that decides a run's `correct`.

Probabilities (the ensemble cells): a sample of the clips answered in the
run, drawn from the seed, the last batch always among them.  Two numbers:

- `logit_err`: the largest relative L2 gap, over the sampled clips and
  members, between the program's and the reference's logits less their
  mean (the centred log-probabilities, which is all that the softmax
  keeps of the logits);
- `pred_err`: the number of sampled clips whose fused prediction is not
  the reference's argmax although the program's own probabilities, summed,
  give the reference's argmax: an exact comparison, limit 0.  A near tie
  that rounding flips in the probabilities (which `logit_err` holds to the
  reference) is not held against the prediction.

Training (one member): the reference follows the program's first steps
from the same weights, rows and augment decisions:

- `loss_err`: the largest |L − L_ref| / |L_ref| over those steps;
- `grad_err`: by the worst leaf, |‖g‖ − ‖g_ref‖| / max(‖g_ref‖, the median
  leaf's ‖g_ref‖), g the first step's gradient, read for the program from
  its optimizer's velocity after that step (v = −lr·g);
- `update_err`: the same of the parameters' change over the steps;
and, compared nowhere, the first step's loss and the median leaf's gaps.
Leaves whose first reference gradient is under a thousandth of the median
leaf's move by round-off alone and are left out (`reference.train.
moved_leaves`).

Each number has its limit in the cell's file; a run is correct when no
number exceeds its limit and no answer failed.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .weights import sub_seed

SAMPLE_STREAM = 11


def sample_clips(seed: int, n_batches: int, batch: int, n: int) -> List[Tuple[int, int]]:
    """`n` distinct (batch position, row) pairs among `n_batches` answered
    batches, one of them in the last batch; sorted."""
    rng = np.random.default_rng(sub_seed(seed, SAMPLE_STREAM))
    total = n_batches * batch
    picks = set(int(i) for i in rng.choice(total, size=min(n, total), replace=False))
    if not any(i // batch == n_batches - 1 for i in picks):
        picks.discard(min(picks))
        picks.add((n_batches - 1) * batch + int(rng.integers(batch)))
    return sorted((i // batch, i % batch) for i in picks)


def probs_readings(probs: torch.Tensor, preds: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    """probs, ref (n, M, C) float; preds (n,) int → logit_err, pred_err, and
    numbers compared nowhere, kept beside them (prob_err, fused_gap,
    prob_rms)."""
    probs, ref = probs.double(), ref.double()
    fused = ref.sum(dim=1)
    best = fused.argmax(dim=1)
    clear = probs.sum(dim=1).argmax(dim=1) == best  # no near tie flipped in the program's probabilities
    wrong = preds.long() != best
    gap = fused.max(dim=1).values - fused.gather(1, preds.long().view(-1, 1)).squeeze(1)
    centred = lambda p: p.clamp_min(1e-300).log() - p.clamp_min(1e-300).log().mean(-1, keepdim=True)  # noqa: E731
    logit = (centred(probs) - centred(ref)).norm(dim=-1) / centred(ref).norm(dim=-1)
    return {"logit_err": float(logit.max()), "pred_err": float((wrong & clear).sum()),
            "clear_clips": float(clear.sum()), "prob_err": float((probs - ref).abs().max()),
            "fused_gap": float(gap.max()), "prob_rms": float((probs - ref).square().mean().sqrt())}


def answers_failed(probs: torch.Tensor) -> int:
    """Clips (dim 1 of (M, B, C)) whose probabilities are not finite or do
    not sum to 1 within 1e-2 for every member."""
    p = probs.double()
    bad = ~torch.isfinite(p).all(dim=-1) | ((p.sum(-1) - 1.0).abs() > 1e-2)
    return int(bad.any(dim=0).sum())


def verdict(readings: Dict[str, float], limits: Dict[str, float]) -> List[Dict]:
    """[{"name", "value", "limit", "ok"}] for every limit; a reading that is
    missing or not finite fails."""
    out = []
    for name, limit in limits.items():
        value = readings.get(name, float("nan"))
        out.append({"name": name, "value": value, "limit": limit, "ok": bool(np.isfinite(value) and value <= limit)})
    return out


def relative_gaps(program: Sequence[float], reference: Sequence[float]) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(program, reference))

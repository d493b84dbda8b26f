"""Published-accuracy target assertions.

Counterpart of `crowded_scenes_ensemble_classification_tpu/ensemble/targets.py`
(lines 37-97), json only.  The reference's published fold accuracies live
in the ISPA 2021 paper, not in its repository; `ACCURACY_TARGETS.json` at
the repo root carries one null slot per experiment configuration until the
numbers are recorded.  Schema::

    {
      "tolerance_pp": 1.0,            # |measured - target| bar, % points
      "targets": {
        "<subfolder_name or GLOBAL>": {"mean_accuracy": null | float,
                                        "per_fold": null | [float, ...]},
        ...
      }
    }
"""

from __future__ import annotations

import json
from dataclasses import dataclass


@dataclass(frozen=True)
class TargetCheck:
    """Outcome of one target assertion: ok is True (within tolerance),
    False (missed), or None (no target recorded yet, never a failure)."""

    ok: "bool | None"
    message: str


def load_targets(path: str) -> dict:
    with open(path) as f:
        spec = json.load(f)
    if "targets" not in spec or not isinstance(spec["targets"], dict):
        raise ValueError(f"{path}: missing 'targets' mapping")
    return spec


def check_target(
    spec: dict,
    key: str,
    mean_accuracy: float,
    per_fold: "list[float] | None" = None,
) -> TargetCheck:
    """Compare a measured accuracy against the recorded target for `key`.
    Accuracies are fractions in [0, 1]; tolerance_pp is percentage points
    (default 1.0)."""
    tol = float(spec.get("tolerance_pp", 1.0)) / 100.0
    entry = spec["targets"].get(key)
    if entry is None:
        return TargetCheck(None, f"no target slot for {key!r} in the targets file — skipped")
    target = entry.get("mean_accuracy")
    if target is None:
        return TargetCheck(
            None,
            f"target for {key!r} is null (ISPA 2021 numbers not yet "
            "recorded; zero-egress environment) — skipped",
        )
    delta = abs(mean_accuracy - float(target))
    parts = [
        f"{key}: measured {mean_accuracy:.4f} vs target {target:.4f} "
        f"(|Δ| {delta * 100:.2f}pp, tol {tol * 100:.2f}pp)"
    ]
    ok = delta <= tol + 1e-9  # exactly at the tolerance passes
    fold_targets = entry.get("per_fold")
    if ok and fold_targets and per_fold is not None:
        for i, (m, t) in enumerate(zip(per_fold, fold_targets)):
            if t is None:
                continue
            d = abs(float(m) - float(t))
            if d > tol + 1e-9:
                ok = False
                parts.append(f"  fold {i}: measured {m:.4f} vs {t:.4f} (|Δ| {d * 100:.2f}pp) MISS")
    parts.append("PASS" if ok else "MISS")
    return TargetCheck(ok, " — ".join(parts))

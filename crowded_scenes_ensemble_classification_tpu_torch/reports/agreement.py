"""Member-agreement ("stick diagram") reporting.

Counterpart of `crowded_scenes_ensemble_classification_tpu/reports/agreement.py`
(lines 1-56), numpy as there; matplotlib is imported inside
`render_agreement_pdf` only.

It mirrors the reference's
stickDiagrams_wellClassifiedClips_per_numberOfModels
(evaluate_ensemble.py:856-999): for each clip, count how many of the k−1
ensemble members classified it correctly (0..k−1), then plot the histogram
of those counts per test fold.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def members_correct_per_clip(member_probs: np.ndarray, labels) -> np.ndarray:
    """(M, N, C) probabilities + (N,) labels → (N,) count of members whose
    argmax equals the label."""
    preds = np.argmax(np.asarray(member_probs), axis=-1)  # (M, N)
    return (preds == np.asarray(labels)[None, :]).sum(axis=0)


def agreement_histogram(counts: np.ndarray, n_members: int) -> np.ndarray:
    """(n_members+1,) histogram of clips by number of correct members."""
    return np.bincount(np.asarray(counts, np.int64), minlength=n_members + 1)


def render_agreement_pdf(
    per_fold_histograms: Sequence[np.ndarray],
    path: str,
    n_members: int,
    subset: str = "test",
) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    k = len(per_fold_histograms)
    fig, axes = plt.subplots(1, k, figsize=(3.2 * k, 3.2), squeeze=False)
    xs = np.arange(n_members + 1)
    for i, hist in enumerate(per_fold_histograms):
        ax = axes[0][i]
        ax.bar(xs, hist, color="steelblue")
        ax.set_title(f"fold {i} ({subset})", fontsize=9)
        ax.set_xlabel("# members correct")
        ax.set_xticks(xs)
        if i == 0:
            ax.set_ylabel("# clips")
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path)
    plt.close(fig)
    return path

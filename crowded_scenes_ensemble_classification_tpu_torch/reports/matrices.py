"""Confusion / difference matrix reporting.

Counterpart of `crowded_scenes_ensemble_classification_tpu/reports/matrices.py`
(lines 1-164), numpy as there; matplotlib is imported inside the render
functions only, so the module imports where it is absent.

It mirrors the reference's reporting components:
- row-normalized per-model and per-ensemble confusion matrices, plus a k-fold
  subplot grid, saved as PDFs (compute_confusion_matrices,
  evaluate_ensemble.py:618-851),
- difference heatmaps (ensemble CM − individual-model CM) with color limits
  [−0.1, 0.2] (compute_difference_matrices, evaluate_ensemble.py:384-615).

Here matrix *computation* is separated from *rendering*: compute functions
return arrays (tested numerically), render functions write the PDFs.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

CROWD11_CLASS_NAMES = [
    "Gas Free",
    "Gas Jammed",
    "Laminar Flow",
    "Turbulent Flow",
    "Crossing Flows",
    "Merging Flow",
    "Diverging Flow",
    "Static Calm",
    "Static Agitated",
    "Interacting Crowd",
    "No Crowd",
]


def confusion_matrix(labels, predictions, num_classes: int) -> np.ndarray:
    """Counts CM (rows = true, cols = predicted)."""
    labels = np.asarray(labels, np.int64)
    predictions = np.asarray(predictions, np.int64)
    cm = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(cm, (labels, predictions), 1)
    return cm


def row_normalize(cm: np.ndarray) -> np.ndarray:
    """Row-normalized CM (the reference normalizes per true-class row)."""
    cm = cm.astype(np.float64)
    sums = cm.sum(axis=1, keepdims=True)
    return np.divide(cm, np.maximum(sums, 1.0))


def difference_matrix(
    ensemble_cm_norm: np.ndarray, model_cm_norm: np.ndarray
) -> np.ndarray:
    """(ensemble − individual), both row-normalized
    (evaluate_ensemble.py:384-615)."""
    return ensemble_cm_norm - model_cm_norm


def per_fold_confusions(
    fold_labels: Sequence[np.ndarray],
    fold_predictions: Sequence[np.ndarray],
    num_classes: int,
) -> List[np.ndarray]:
    return [
        row_normalize(confusion_matrix(l, p, num_classes))
        for l, p in zip(fold_labels, fold_predictions)
    ]


# ----------------------------------------------------------------------
# Rendering (matplotlib, Agg)
# ----------------------------------------------------------------------


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def render_confusion_pdf(
    cm_norm: np.ndarray,
    path: str,
    title: str = "",
    class_names: Optional[Sequence[str]] = None,
) -> str:
    plt = _plt()
    n = cm_norm.shape[0]
    names = list(class_names or range(n))
    fig, ax = plt.subplots(figsize=(8, 7))
    im = ax.imshow(cm_norm, cmap="Blues", vmin=0.0, vmax=1.0)
    ax.set_xticks(range(n), names, rotation=90, fontsize=7)
    ax.set_yticks(range(n), names, fontsize=7)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    ax.set_title(title)
    for i in range(n):
        for j in range(n):
            if cm_norm[i, j] >= 0.005:
                ax.text(
                    j, i, f"{cm_norm[i, j]:.2f}", ha="center", va="center",
                    fontsize=6, color="black" if cm_norm[i, j] < 0.6 else "white",
                )
    fig.colorbar(im)
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path)
    plt.close(fig)
    return path


def render_confusion_grid_pdf(
    cms_norm: Sequence[np.ndarray],
    path: str,
    titles: Optional[Sequence[str]] = None,
    class_names: Optional[Sequence[str]] = None,
) -> str:
    """k-fold subplot grid (evaluate_ensemble.py's per-fold panels)."""
    plt = _plt()
    k = len(cms_norm)
    cols = min(k, 3)
    rows = (k + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(5 * cols, 4.5 * rows), squeeze=False)
    for idx, cm in enumerate(cms_norm):
        ax = axes[idx // cols][idx % cols]
        ax.imshow(cm, cmap="Blues", vmin=0.0, vmax=1.0)
        ax.set_title((titles or [f"fold {i}" for i in range(k)])[idx], fontsize=9)
        ax.set_xticks([])
        ax.set_yticks([])
    for idx in range(k, rows * cols):
        axes[idx // cols][idx % cols].axis("off")
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path)
    plt.close(fig)
    return path


def render_difference_pdf(
    diff: np.ndarray,
    path: str,
    title: str = "",
    class_names: Optional[Sequence[str]] = None,
) -> str:
    """Heatmap with the reference's clim [−0.1, 0.2]
    (evaluate_ensemble.py:456-460)."""
    plt = _plt()
    n = diff.shape[0]
    names = list(class_names or range(n))
    fig, ax = plt.subplots(figsize=(8, 7))
    im = ax.imshow(diff, cmap="RdYlGn", vmin=-0.1, vmax=0.2)
    ax.set_xticks(range(n), names, rotation=90, fontsize=7)
    ax.set_yticks(range(n), names, fontsize=7)
    ax.set_title(title)
    fig.colorbar(im)
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path)
    plt.close(fig)
    return path

"""Probability cache: typed npz tensors with the reference's CSV export.

Counterpart of `crowded_scenes_ensemble_classification_tpu/ensemble/probability_store.py`
(lines 20-94).  The reference cached each member's softmax matrix as a
stringified numpy array inside a CSV cell (store_probabilities
evaluate_ensemble.py:1002-1109, parsed back by string surgery and
ast.literal_eval :65-73).  Here, as in the JAX package, the cache is one
npz per (ensemble, test fold, subset): probs (M, N, C) float32, labels
(N,), member names, with an exporter that writes the legacy
`(path, probabilities)` CSV.  The CSVs are written with the `csv` module
(no pandas on the card's machine) and equal pandas' output byte for byte:
minimal quoting, `\\n` line ends.
"""

from __future__ import annotations

import ast
import csv
import os
from typing import Dict, List, Sequence

import numpy as np


def write_csv(path: str, header: Sequence[str], rows: Sequence[Sequence[str]]) -> str:
    """`pandas.DataFrame(rows, columns=header).to_csv(path, index=False)`
    for string cells."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(header)
        writer.writerows(rows)
    return path


def probability_cache_path(
    cache_dir: str,
    ensemble_name: str,
    test_index: int,
    subset: str,
    variant: str = "",
) -> str:
    """subset ∈ {'test', 'train_val'} (reference evaluate_ensemble.py:1722).
    variant distinguishes alternative inference modes over the same
    (ensemble, fold, subset), e.g. '_long80s8' for long-video window scans."""
    return os.path.join(
        cache_dir,
        f"{ensemble_name}_test{test_index}_{subset}{variant}_probabilities.npz",
    )


def save_probabilities(
    path: str,
    probs: np.ndarray,
    labels: np.ndarray,
    member_names: Sequence[str],
) -> str:
    probs = np.asarray(probs)
    if probs.ndim != 3 or probs.shape[1] != len(labels):
        raise ValueError(f"probs must be (M, N, C) with N = {len(labels)} labels, got {probs.shape}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(
        path,
        probs=probs.astype(np.float32),
        labels=np.asarray(labels, np.int32),
        member_names=np.asarray(list(member_names)),
    )
    return path


def load_probabilities(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {
            "probs": z["probs"],
            "labels": z["labels"],
            "member_names": [str(x) for x in z["member_names"]],
        }


def probabilities_exist(path: str) -> bool:
    return os.path.exists(path)


def export_reference_csv(npz_path: str, csv_path: str) -> str:
    """Write the legacy `(path, probabilities)` CSV whose cells parse with
    the reference's convert_str2array (evaluate_ensemble.py:65-73):
    `ast.literal_eval` of a nested list literal."""
    data = load_probabilities(npz_path)
    rows = [(name, repr(mat.tolist())) for name, mat in zip(data["member_names"], data["probs"])]
    return write_csv(csv_path, ("path", "probabilities"), rows)


def import_reference_csv(csv_path: str, num_classes: int) -> Dict[str, np.ndarray]:
    """Read a legacy probability CSV (ours or the reference's) back into the
    typed tensor form."""
    names: List[str] = []
    mats: List[np.ndarray] = []
    with open(csv_path, newline="", encoding="utf-8") as f:
        for row in csv.DictReader(f):
            s = row["probabilities"].replace("array(", "").replace(", dtype=float32)", "")
            mats.append(np.asarray(ast.literal_eval(s), np.float32).reshape(-1, num_classes))
            names.append(row["path"])
    return {"probs": np.stack(mats), "member_names": names}

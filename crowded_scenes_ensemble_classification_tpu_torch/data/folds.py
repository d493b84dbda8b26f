"""Scene-stratified k-fold generation.

Counterpart of `crowded_scenes_ensemble_classification_tpu/data/folds.py`
(lines 34-163), the reference's greedy fold builder
(generate_folds.py:163-204): repeatedly take the scene with the most clips
and assign it to the fold with the lowest class-distribution score, where a
fold's score grows by `1 / (class_frequency / k)` for every clip label the
scene contributes (generate_folds.py:142-156).  Scenes never straddle
folds, so no scene leaks between train and test.

The clip table is a `ClipTable` (columns rgbclips_path,
x/y_axis_flowclips_path, scene_number, label); the fold CSVs keep the
reference's columns (`rgbclips_path, x_axis_flowclips_path,
y_axis_flowclips_path, class`, generate_folds.py:96) and equal the JAX
package's pandas files byte for byte.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .table import ClipTable

FOLD_CSV_COLUMNS = [
    "rgbclips_path",
    "x_axis_flowclips_path",
    "y_axis_flowclips_path",
    "class",
]


def assign_scenes_to_folds(
    scene_labels: Dict[object, Sequence[int]],
    nb_folds: int,
    num_classes: Optional[int] = None,
) -> List[List[object]]:
    """Greedy scene→fold assignment.

    scene_labels: {scene_id: [label of each clip in the scene]}.
    Returns nb_folds lists of scene ids (disjoint, covering all scenes).
    """
    all_labels = [l for labels in scene_labels.values() for l in labels]  # noqa: E741
    if num_classes is None:
        num_classes = int(max(all_labels)) + 1
    class_freq = np.bincount(np.asarray(all_labels, np.int64), minlength=num_classes)

    remaining = list(scene_labels.keys())
    counts = [len(scene_labels[s]) for s in remaining]
    fold_scores = np.zeros((nb_folds, num_classes), np.float64)
    folds: List[List[object]] = [[] for _ in range(nb_folds)]

    while remaining:
        # the largest scene, first occurrence (reference list.index(max(...)))
        i = int(np.argmax(counts))
        scene = remaining.pop(i)
        counts.pop(i)
        # the fold with the lowest mean score, first occurrence
        target = int(np.argmin(fold_scores.sum(axis=1) / num_classes))
        folds[target].append(scene)
        for label in scene_labels[scene]:
            if class_freq[label] > 0:
                fold_scores[target, label] += 1.0 / (class_freq[label] / nb_folds)
    return folds


def scene_labels_from_dataframe(
    df: ClipTable,
    scene_col: str = "scene_number",
    label_col: str = "label",
) -> Dict[object, List[int]]:
    """{scene: [its clips' labels]}, scenes in order of first appearance
    (pandas `groupby(sort=False)`)."""
    out: Dict[object, List[int]] = {}
    for scene, label in zip(df[scene_col].tolist(), df[label_col].tolist()):
        out.setdefault(scene, []).append(int(label))
    return out


def verify_folds_disjoint(folds_scenes: Sequence[Sequence[object]]) -> bool:
    """Scene sets must not overlap (reference verify_folds_intersection,
    generate_folds.py:14-24, as a verdict instead of a print)."""
    seen = set()
    for scenes in folds_scenes:
        s = set(scenes)
        if s & seen:
            return False
        seen |= s
    return True


def fold_class_histograms(
    df: ClipTable,
    folds_scenes: Sequence[Sequence[object]],
    num_classes: int,
    scene_col: str = "scene_number",
    label_col: str = "label",
) -> np.ndarray:
    """(k, num_classes) label counts per fold (reference folds_histograms,
    generate_folds.py:101-114, as data instead of a plot)."""
    out = np.zeros((len(folds_scenes), num_classes), np.int64)
    for i, scenes in enumerate(folds_scenes):
        labels = np.asarray(df[label_col][df.isin(scene_col, scenes)], np.int64)
        out[i] = np.bincount(labels, minlength=num_classes)
    return out


def make_fold_dataframes(
    df: ClipTable,
    folds_scenes: Sequence[Sequence[object]],
    scene_col: str = "scene_number",
    label_col: str = "label",
    rgb_col: str = "rgbclips_path",
    flow_x_col: str = "x_axis_flowclips_path",
    flow_y_col: str = "y_axis_flowclips_path",
) -> List[ClipTable]:
    """Slice the clip table into per-fold tables with the reference CSV
    columns (generate_folds.py:88-96), sorted by rgb path like the
    reference's sorted listing (generate_folds.py:78)."""
    folds = []
    for scenes in folds_scenes:
        sub = df.filter(df.isin(scene_col, scenes))
        fold = ClipTable({
            "rgbclips_path": sub[rgb_col],
            "x_axis_flowclips_path": sub[flow_x_col],
            "y_axis_flowclips_path": sub[flow_y_col],
            "class": np.asarray(sub[label_col], np.int64),
        })
        folds.append(fold.sort_values("rgbclips_path"))
    return folds


def write_fold_csvs(fold_dfs: Sequence[ClipTable], parent_folds_folder: str, nb_folds: int) -> str:
    """Write `{parent}/{k}_folds/fold{i}.csv` (generate_folds.py:50-99)."""
    folds_folder = os.path.join(parent_folds_folder, f"{nb_folds}_folds")
    os.makedirs(folds_folder, exist_ok=True)
    for i, fold in enumerate(fold_dfs):
        fold.to_csv(os.path.join(folds_folder, f"fold{i}.csv"))
    return folds_folder


def generate_folds(
    clip_table: ClipTable,
    parent_folds_folder: str,
    nb_folds: int,
    num_classes: Optional[int] = None,
) -> Tuple[str, List[List[object]]]:
    """Greedy assignment, then the fold CSVs.  `clip_table` has the columns
    rgbclips_path, x/y_axis_flowclips_path, scene_number and label.
    Returns (the folds folder, the scenes of each fold)."""
    folds_scenes = assign_scenes_to_folds(scene_labels_from_dataframe(clip_table), nb_folds, num_classes)
    if not verify_folds_disjoint(folds_scenes):
        raise AssertionError("a scene was assigned to two folds")
    folder = write_fold_csvs(make_fold_dataframes(clip_table, folds_scenes), parent_folds_folder, nb_folds)
    return folder, folds_scenes

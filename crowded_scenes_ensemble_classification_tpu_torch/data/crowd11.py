"""Crowd-11 dataset adapter: database CSV + rgb/flow directories → clip table.

Counterpart of `crowded_scenes_ensemble_classification_tpu/data/crowd11.py`
(lines 1-66).  The reference derived labels and scenes by regex over file
names shaped `{label}_{scene}_{idx}_{name}.mp4` and matched them against the
metadata CSV's `video_name` column (generate_folds.py:56-90, 142-156).
`build_clip_table` gives the clip table (`rgbclips_path`,
`x/y_axis_flowclips_path`, `scene_number`, `label`, `video_name`) in one
pass, by the same rules, with the CSV read by the `csv` module.
"""

from __future__ import annotations

import os
import re
from typing import Optional

from .synthetic import CLIP_TABLE_COLUMNS
from .table import ClipTable

# `{label}_{scene}_{clipidx}_{rest}.{mp4|avi}` (generate_folds.py:61-87)
_CLIP_RE = re.compile(r"^(\d{1,2})_(\d+)_(\d{1,2})_(.*)\.(mp4|avi)$")


def build_clip_table(dataset_directory: str, database_file: Optional[str] = None) -> ClipTable:
    """Scan `{dataset}/rgb` (sorted) for clip names; with a database CSV
    (columns scene_number, video_name, label) a clip whose inner name (the
    file name without its `label_scene_idx_` prefix) matches a row's
    `video_name` without extension takes that row's scene and label, else
    they come from the file name.  Flow paths are `{dataset}/flow/{stem}_x.avi`
    and `_y.avi`."""
    rgb_dir = os.path.join(dataset_directory, "rgb")
    flow_dir = os.path.join(dataset_directory, "flow")
    videos = sorted(os.listdir(rgb_dir))

    name_to_row = None
    if database_file:
        name_to_row = {os.path.splitext(str(r["video_name"]))[0]: r for r in ClipTable.read_csv(database_file).rows()}

    rows = []
    for video in videos:
        m = _CLIP_RE.match(video)
        if not m:
            continue
        label, scene = int(m.group(1)), int(m.group(2))
        stem = os.path.splitext(video)[0]
        if name_to_row is not None:
            row = name_to_row.get(m.group(4))
            if row is not None:
                scene = int(row["scene_number"])
                label = int(row["label"])
        rows.append({
            "rgbclips_path": os.path.join(rgb_dir, video),
            "x_axis_flowclips_path": os.path.join(flow_dir, stem + "_x.avi"),
            "y_axis_flowclips_path": os.path.join(flow_dir, stem + "_y.avi"),
            "scene_number": scene,
            "label": label,
            "video_name": video,
        })
    return ClipTable.from_records(rows, CLIP_TABLE_COLUMNS)

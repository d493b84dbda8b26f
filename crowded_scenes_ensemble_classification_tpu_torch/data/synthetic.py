"""Synthetic crowd-video dataset for tests and the card's ingest check.

Counterpart of `crowded_scenes_ensemble_classification_tpu/data/synthetic.py`
(lines 21-107): small videos whose class is visible (each class a distinct
moving-stripe signature and mean brightness), laid out as Crowd-11 is
(`rgb/`, `flow/`, clip names `{label}_{scene}_{idx}_clip`), with the clip
table (rgb and x/y flow paths, scene_number, label, video_name) returned as
a `ClipTable`.  The arrays come from the same `np.random.default_rng(seed)`
stream as JAX's, draw for draw, so both packages write the same clips.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from .table import ClipTable
from .video_io import HAVE_CV2, write_video

CLIP_TABLE_COLUMNS = [
    "rgbclips_path",
    "x_axis_flowclips_path",
    "y_axis_flowclips_path",
    "scene_number",
    "label",
    "video_name",
]


def make_clip_array(
    label: int,
    rng: np.random.Generator,
    num_frames: int = 12,
    hw: Tuple[int, int] = (64, 64),
    num_classes: int = 4,
) -> np.ndarray:
    """A (T, H, W, 3) uint8 clip: class-dependent moving stripes + noise."""
    t, (h, w) = num_frames, hw
    ys, xs = np.mgrid[0:h, 0:w]
    freq = 2 * np.pi * (label + 1) / 16.0
    phase_step = (label % 2 * 2 - 1) * (1 + label // 2)
    # a per-class mean brightness makes the task learnable in a few steps
    mean = 40.0 + 170.0 * (label + 0.5) / num_classes
    frames = []
    for i in range(t):
        base = mean + 35.0 * np.sin(freq * (xs + phase_step * i) + 0.3 * ys)
        noise = rng.normal(0, 8, size=(h, w))
        g = np.clip(base + noise, 0, 255)
        frame = np.stack([g, np.roll(g, label, axis=1), np.roll(g, -label, axis=0)], -1)
        frames.append(frame)
    return np.asarray(frames, np.uint8)


def generate_synthetic_dataset(
    root: str,
    num_scenes: int = 12,
    clips_per_scene: int = 3,
    num_classes: int = 4,
    num_frames: int = 12,
    hw: Tuple[int, int] = (64, 64),
    seed: int = 0,
    write_flow: bool = True,
    as_videos: bool = True,
) -> ClipTable:
    """Write the clips under `root` (mp4 through cv2, or .npy when
    `as_videos` is false or cv2 is missing) and return the clip table.
    Scene s holds class s % num_classes.  With `write_flow`, each clip gets
    a synthetic "flow" pair (temporal difference magnitudes as two gray
    videos, the `_x.avi`/`_y.avi` convention); without it the flow paths
    are empty."""
    rng = np.random.default_rng(seed)
    rgb_dir = os.path.join(root, "rgb")
    flow_dir = os.path.join(root, "flow")
    os.makedirs(rgb_dir, exist_ok=True)
    os.makedirs(flow_dir, exist_ok=True)
    videos = as_videos and HAVE_CV2

    rows = []
    for scene in range(num_scenes):
        label = scene % num_classes
        for c in range(clips_per_scene):
            stem = f"{label}_{scene}_{c}_clip"
            clip = make_clip_array(label, rng, num_frames, hw, num_classes)
            rgb_path = os.path.join(rgb_dir, stem + (".mp4" if videos else ".npy"))
            if videos:
                write_video(rgb_path, clip)
            else:
                np.save(rgb_path, clip)
            fx_path = fy_path = ""
            if write_flow:
                diff = np.abs(np.diff(clip.astype(np.int16), axis=0)).astype(np.uint8)
                diff = np.concatenate([diff, diff[-1:]], axis=0)
                fx, fy = diff[..., 0:1], diff[..., 1:2]
                if videos:
                    fx_path = os.path.join(flow_dir, stem + "_x.avi")
                    fy_path = os.path.join(flow_dir, stem + "_y.avi")
                    write_video(fx_path, np.repeat(fx, 3, -1))
                    write_video(fy_path, np.repeat(fy, 3, -1))
                else:
                    fx_path = os.path.join(flow_dir, stem + "_x.npy")
                    fy_path = os.path.join(flow_dir, stem + "_y.npy")
                    np.save(fx_path, fx)
                    np.save(fy_path, fy)
            rows.append({
                "rgbclips_path": rgb_path,
                "x_axis_flowclips_path": fx_path,
                "y_axis_flowclips_path": fy_path,
                "scene_number": scene,
                "label": label,
                "video_name": os.path.basename(rgb_path),
            })
    return ClipTable.from_records(rows, CLIP_TABLE_COLUMNS)

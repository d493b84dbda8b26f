"""Offline ("precomputed") augmentation: augmented mp4 copies of every fold clip.

Counterpart of `crowded_scenes_ensemble_classification_tpu/data/augment_offline.py`
(lines 1-126), the reference augment_dataset.py: `augmentation_frequency`
augmented copies of every clip of every fold, and `rgbclips_augmented_{i}_path`
columns appended to the fold CSVs (augment_dataset.py:88-123).  Idempotent
like the reference: existing columns are skipped, and `operation=
'update_links'` rewrites the columns without encoding a video
(augment_dataset.py:131-148).  The rewritten CSVs are byte for byte what
the JAX package's pandas writes.

Decode stays cv2 on the host (every frame of the clip).  The pixel policy,
Sometimes(0.85) crop, flip, salt and pepper with a resize to 224²
(augment_dataset.py:16-32, :74-83), runs on the device one clip at a time,
whatever its (T, H, W): `ops.augment.crowd11_augment`, whose salt/pepper is
the noise kernel on the card.  The float output is truncated to uint8 as
JAX's `astype(np.uint8)` does (augment_offline.py:68), not rounded.

Randomness: each copy's decisions come from a CPU `torch.Generator` seeded
by `offline_seed(seed, fold, clip index, frequency)`, so re-runs are
bit-equal on any device.  JAX keys a threefry fold-in chain by the same
four numbers; torch cannot replay threefry, so the two packages draw
different decisions.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.augment import crowd11_augment
from ..utils.device import resolve_device
from .table import ClipTable
from .video_io import _require_cv2, cv2, write_video

OFFLINE_AUGMENT_P = 0.85  # JAX augment_offline.py:30 (reference augment_dataset.py:74)
OFFLINE_OUT_HW = (224, 224)  # JAX augment_offline.py:31 (reference augment_dataset.py:78)


def offline_seed(seed: int, fold_index: int, clip_index: int, frequency: int) -> int:
    """The 64-bit generator seed of one augmented copy: the first uint64
    word of numpy's `SeedSequence([seed, fold_index, clip_index, frequency])`."""
    words = [seed, fold_index, clip_index, frequency]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0])


def _load_full_clip(path: str) -> np.ndarray:
    """Every frame of a video (or a `.npy` clip) as (T, H, W, 3) uint8 BGR."""
    if path.endswith(".npy"):
        return np.load(path)
    _require_cv2()
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    if not frames:
        raise IOError(f"could not decode {path}")
    return np.stack(frames)


def augment_clip(
    clip: np.ndarray,
    seed: int,
    device,
    out_hw: Tuple[int, int] = OFFLINE_OUT_HW,
    p: float = OFFLINE_AUGMENT_P,
) -> np.ndarray:
    """(T, H, W, 3) uint8 → the policy on `device` → (T, oh, ow, 3) uint8,
    truncated; its decisions from a CPU generator seeded by `seed`."""
    x = torch.from_numpy(np.ascontiguousarray(clip)).to(device)
    out = crowd11_augment(x, out_hw, p, torch.Generator().manual_seed(seed))
    return out.to(torch.uint8).cpu().numpy()


def augment_video_file(src_path: str, dst_path: str, seed: int, device=None) -> str:
    """Decode → augment on `device` (the card when None) → write mp4
    (reference augment_video + write_video, augment_dataset.py:34-85)."""
    clip = _load_full_clip(src_path)
    write_video(dst_path, augment_clip(clip, seed, resolve_device(device)), fps=20.0)
    return dst_path


def augment_folds(
    folds_folder: str,
    augmented_data_folder: str,
    nb_folds: int,
    augmentation_frequency: int,
    operation: str = "augment_videos",  # or "update_links"
    seed: int = 0,
    device=None,
) -> None:
    """Augment every fold CSV in place (reference augment_folds,
    augment_dataset.py:88-123).  A copy whose file exists is not encoded
    again; the device (the card when None) is resolved only when a copy is
    encoded."""
    if operation not in ("augment_videos", "update_links"):
        raise ValueError(f"operation {operation!r} not in ('augment_videos', 'update_links')")
    os.makedirs(augmented_data_folder, exist_ok=True)
    resolved: Optional[torch.device] = None
    for fold_index in range(nb_folds):
        fold_path = os.path.join(folds_folder, f"fold{fold_index}.csv")
        table = ClipTable.read_csv(fold_path)
        changed = False
        for freq in range(augmentation_frequency):
            column = f"rgbclips_augmented_{freq}_path"
            if column in table and operation != "update_links":
                continue
            paths = []
            for clip_index, src in enumerate(table["rgbclips_path"]):
                stem = os.path.splitext(os.path.basename(src))[0]
                dst = os.path.join(augmented_data_folder, f"{stem}_augmented_{freq}.mp4")
                paths.append(dst)
                if operation == "augment_videos" and not os.path.exists(dst):
                    resolved = resolved or resolve_device(device)
                    augment_video_file(src, dst, offline_seed(seed, fold_index, clip_index, freq), resolved)
            table[column] = paths
            changed = True
        if changed:
            table.to_csv(fold_path)

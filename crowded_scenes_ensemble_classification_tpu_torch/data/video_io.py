"""Host video decode and encode: cv2, stride frame selection, the staging resize.

Counterpart of `crowded_scenes_ensemble_classification_tpu/data/video_io.py`
(lines 1-227), the same code: decode is the one stage that stays on the host
(no video codec runs on the card).  Unlike the reference, which decoded every
frame of every clip into Python lists each epoch (train.py:160-172,
257-269), the decoder

- reads the stream once, `grab()`-ing unwanted frames and `retrieve()`-ing
  only the stride-selected ones (no BGR conversion or numpy copy for frames
  it will not use),
- resizes the kept frames to a fixed staging geometry (cv2 INTER_LINEAR), so
  batches are uniform and the card does all augmentation math,
- returns a contiguous uint8 array.

Frame selection is the reference `select_frames` (train.py:132-145): step =
max(T//n, 1), indices i*step for i < n, cycled when the clip is shorter than
n (`ops.temporal.select_frame_indices`).  Without cv2 every function raises
(`HAVE_CV2` says whether it imports).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

try:
    import cv2

    HAVE_CV2 = True
except Exception:  # pragma: no cover
    cv2 = None
    HAVE_CV2 = False

from ..ops.temporal import select_frame_indices


def _require_cv2():
    if not HAVE_CV2:
        raise RuntimeError("OpenCV is required for host video decode")


def video_frame_count(path: str) -> int:
    _require_cv2()
    cap = cv2.VideoCapture(path)
    try:
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()
    return n


def decode_clip(
    path: str,
    num_frames: int,
    staging_hw: Optional[Tuple[int, int]] = None,
    gray: bool = False,
) -> np.ndarray:
    """Decode `num_frames` stride-selected frames → uint8
    (num_frames, H, W, C), BGR like the reference (C=1 when gray)."""
    _require_cv2()
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        cap.open(path)
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))

    frames = []
    if total and total > 0:
        wanted = set(int(i) for i in select_frame_indices(total, num_frames))
        last = max(wanted)
        idx = 0
        while idx <= last:
            if idx in wanted:
                ok, frame = cap.read()
            else:
                ok = cap.grab()
                frame = None
            if not ok:
                break
            if frame is not None:
                frames.append(_stage_frame(frame, staging_hw, gray))
            idx += 1
        order = sorted(wanted)
    else:
        # Unknown length: full sequential decode, select afterwards.
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(_stage_frame(frame, staging_hw, gray))
        order = None
    cap.release()

    if not frames:
        raise IOError(f"could not decode any frames from {path}")

    if order is None:
        sel = select_frame_indices(len(frames), num_frames)
        frames = [frames[i] for i in sel]
    else:
        frames = _pad_cycle(frames, num_frames)
    return np.stack(frames)


def _pad_cycle(frames: list, num_frames: int) -> list:
    """Pad a too-short decoded list by cycling [f0, f1, ...] — the
    select_frame_indices cycle rule — indexing into the *decoded* prefix,
    not the growing list (used when the container lied about its length)."""
    n0 = len(frames)
    while len(frames) < num_frames:
        frames.append(frames[len(frames) % n0])
    return frames[:num_frames]


def _stage_frame(frame: np.ndarray, staging_hw, gray: bool) -> np.ndarray:
    if gray and frame.ndim == 3 and frame.shape[2] == 3:
        frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
    if staging_hw is not None and frame.shape[:2] != tuple(staging_hw):
        frame = cv2.resize(
            frame, (staging_hw[1], staging_hw[0]), interpolation=cv2.INTER_LINEAR
        )
    if frame.ndim == 2:
        frame = frame[:, :, None]
    return np.ascontiguousarray(frame)


def decode_twostream_staging(
    path: str,
    num_frames: int,
    staging_hw: Optional[Tuple[int, int]] = None,
):
    """ONE decode pass producing what the on-device Farnebäck path needs:
    rgb at the selected indices plus gray at (selected, selected+1) frame
    pairs — so the device computes exactly the reference's per-consecutive-
    pair flow maps at the selected indices (train.py:294-332 computed flow
    for every pair then stride-selected, train.py:231).

    Returns dict(rgb (T,H,W,3), gray (T,H,W,1), gray_next (T,H,W,1)),
    all uint8."""
    _require_cv2()
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        cap.open(path)
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    if total <= 0:
        # decode everything, select after
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame)
        cap.release()
        if not frames:
            raise IOError(f"could not decode any frames from {path}")
        total = len(frames)
        sel = select_frame_indices(total, num_frames)
        nxt = np.minimum(sel + 1, total - 1)
        rgb = np.stack([_stage_frame(frames[i], staging_hw, False) for i in sel])
        gray = np.stack([_stage_frame(frames[i], staging_hw, True) for i in sel])
        gray_next = np.stack(
            [_stage_frame(frames[i], staging_hw, True) for i in nxt]
        )
        return {"rgb": rgb, "gray": gray, "gray_next": gray_next}

    sel = select_frame_indices(total, num_frames)
    nxt = np.minimum(sel + 1, total - 1)
    wanted = sorted(set(int(i) for i in sel) | set(int(i) for i in nxt))
    staged_rgb: dict = {}
    staged_gray: dict = {}
    wanted_set = set(wanted)
    idx = 0
    last = wanted[-1]
    while idx <= last:
        if idx in wanted_set:
            ok, frame = cap.read()
            if not ok:
                break
            staged_rgb[idx] = _stage_frame(frame, staging_hw, False)
            staged_gray[idx] = _stage_frame(frame, staging_hw, True)
        else:
            if not cap.grab():
                break
        idx += 1
    cap.release()
    if not staged_rgb:
        raise IOError(f"could not decode any frames from {path}")

    def fetch(table, i):
        # fall back to the closest decoded frame if the container lied
        if i in table:
            return table[i]
        keys = sorted(table)
        return table[min(keys, key=lambda k: abs(k - i))]

    rgb = np.stack([fetch(staged_rgb, int(i)) for i in sel])
    gray = np.stack([fetch(staged_gray, int(i)) for i in sel])
    gray_next = np.stack([fetch(staged_gray, int(i)) for i in nxt])
    return {"rgb": rgb, "gray": gray, "gray_next": gray_next}


def decode_flow_pair(
    x_path: str,
    y_path: str,
    num_frames: int,
    staging_hw: Optional[Tuple[int, int]] = None,
) -> np.ndarray:
    """Load precomputed TV-L1 flow stored as two gray videos
    ({clip}_x.avi / {clip}_y.avi, reference train.py:335-358) →
    uint8 (num_frames, H, W, 2)."""
    fx = decode_clip(x_path, num_frames, staging_hw, gray=True)
    fy = decode_clip(y_path, num_frames, staging_hw, gray=True)
    return np.concatenate([fx, fy], axis=-1)


def write_video(path: str, frames: np.ndarray, fps: float = 20.0) -> None:
    """Encode (T, H, W, 3) uint8 BGR to mp4 — the offline-augmentation
    writer (reference augment_dataset.py:34-50 wrote mp4v@20fps; note the
    reference passed (W,H) swapped — we pass the true (width, height))."""
    _require_cv2()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    h, w = frames.shape[1:3]
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    try:
        for f in frames:
            out.write(np.ascontiguousarray(f.astype(np.uint8)))
    finally:
        out.release()

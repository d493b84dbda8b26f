"""Streaming long-video evaluation: window scans with averaged softmax scores.

Counterpart of `crowded_scenes_ensemble_classification_tpu/parallel/streaming.py`
(lines 1-185; it uses no mesh).  The reference classified one 16/20-frame
subsample of each video (select_frames, train.py:132-145); here overlapping
model windows are scanned over a long clip and their softmax scores
averaged, the reference's per-clip fusion math (evaluate_ensemble.py:
362-366) extended along time.  Windows become the batch axis, so one
forward runs every window of every clip of a batch.

There a jitted closure vmaps over stacked member variables; here the
members are modules run one after another, as in `ensemble.members`, and
I3D members share one s2d stem staging of all windows (`stem_prestaged`
members, JAX streaming.py:104-109).
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..data.pipeline import iterate_batches
from ..ensemble.members import check_member_form
from ..models.common import s2d_stem_stage
from ..models.i3d import I3D
from ..models.registry import ModelBundle
from ..ops.augment import identity_resize_batch


def window_starts(num_frames: int, window: int, stride: int) -> np.ndarray:
    """Start indices covering the clip; the tail window is clamped so the
    last frames are always seen."""
    if num_frames <= window:
        return np.zeros(1, np.int64)
    starts = np.arange(0, num_frames - window + 1, stride)
    if starts[-1] != num_frames - window:
        starts = np.append(starts, num_frames - window)
    return starts


def extract_windows(clip: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """(T, H, W, C) → (num_windows, window, H, W, C) gather (frames past
    the end repeat the last one)."""
    t = int(clip.shape[0])
    starts = window_starts(t, window, stride)
    idx = np.minimum(starts[:, None] + np.arange(window)[None, :], t - 1)
    flat = torch.as_tensor(idx.reshape(-1), device=clip.device)
    return clip.index_select(0, flat).reshape((len(starts), window) + tuple(clip.shape[1:]))


def streaming_predict(
    bundle: ModelBundle,
    clip: torch.Tensor,
    stride: Optional[int] = None,
    input_scale: float = 1.0,
) -> torch.Tensor:
    """Average softmax over all windows of one long clip → (C,) scores.  The
    clip is at the model's spatial size; the window is its frame count."""
    window = bundle.clip.frames
    stride = stride or window // 2
    wins = extract_windows(clip.float() * input_scale, window, stride)
    with torch.inference_mode():
        logits = bundle.apply({"rgb": wins.to(bundle.module.dtype)})
    return torch.softmax(logits.float(), -1).mean(0)


def streaming_predict_batch(
    bundle: ModelBundle,
    clips: torch.Tensor,
    stride: Optional[int] = None,
    input_scale: float = 1.0,
) -> torch.Tensor:
    """(B, T, H, W, C) long clips → (B, C) averaged scores; the windows of
    all clips run as one batch."""
    window = bundle.clip.frames
    stride = stride or window // 2
    b = int(clips.shape[0])
    wins = torch.stack([extract_windows(c, window, stride) for c in clips.float() * input_scale])
    n_win = wins.shape[1]
    with torch.inference_mode():
        logits = bundle.apply({"rgb": wins.flatten(0, 1).to(bundle.module.dtype)})
    return torch.softmax(logits.float(), -1).reshape(b, n_win, -1).mean(1)


def streaming_member_probabilities(
    members: Sequence[nn.Module],
    clips: torch.Tensor,
    window: int,
    stride: Optional[int] = None,
    input_scale: float = 1.0,
) -> torch.Tensor:
    """Long-video ensemble inference: (B, T, H, W, C) clips at the model's
    spatial size × M members of one family → (M, B, C) window-averaged
    softmax scores, float32.  I3D members are `stem_prestaged` and share the
    windows' s2d staging; the other families take the windows."""
    share = isinstance(members[0], I3D)
    check_member_form(members, share)
    stride = stride or window // 2
    b = int(clips.shape[0])
    wins = torch.stack([extract_windows(c, window, stride) for c in clips.float() * input_scale])
    n_win = wins.shape[1]
    x = wins.flatten(0, 1).to(members[0].dtype)
    with torch.inference_mode():
        if share:
            x = s2d_stem_stage(x)
        return torch.stack([torch.softmax(m(x).float(), -1).reshape(b, n_win, -1).mean(1) for m in members])


def streaming_member_probabilities_over_pipeline(
    members: Sequence[nn.Module],
    batches: Iterable,
    out_hw: Tuple[int, int],
    window: int,
    stride: Optional[int] = None,
    input_scale: float = 1.0,
) -> np.ndarray:
    """`ensemble.members.member_probabilities` for LONG clips: batches of
    (B, T≫window, S, S, 3) uint8 clips (a `BatchPipeline`, prefetched, or
    an iterable of batch dicts) → resized to `out_hw` on the members'
    device → per-member window scans → (M, N, C) float32 of the valid rows
    in batch order."""
    device = next(members[0].parameters()).device
    chunks = []
    with iterate_batches(batches) as stream:
        for batch in stream:
            clips = identity_resize_batch(torch.as_tensor(batch["rgb"]).to(device), out_hw)
            probs = streaming_member_probabilities(members, clips, window, stride, input_scale).cpu().numpy()
            valid = np.asarray(batch.get("valid", np.ones(probs.shape[1], bool)), bool)
            chunks.append(probs[:, valid])
    return np.concatenate(chunks, axis=1)

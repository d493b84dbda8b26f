"""Temporal (frame-axis) transforms: frame selection and the vidaug temporal ops.

Counterpart of `crowded_scenes_ensemble_classification_tpu/ops/temporal.py`
(lines 1-120).  `select_frame_indices` picks the decoder's and the `.npy`
loader's frames on the host (`data/video_io.py`, `data/pipeline.py`); the
transforms take a clip (T, …) tensor and gather frames by index, as there:

- the reference's loop-pad (a clip shorter than `size` cycles its frames)
  is `idx % span`;
- vidaug `InverseOrder` drops frame 0 (temporal.py:108-116); the full
  reverse is what is implemented, as in JAX.

`temporal_random_crop` and `temporal_elastic_transformation` draw from a
`torch.Generator` and call the deterministic cores `temporal_crop_at` and
`temporal_elastic_indices`.
"""

from __future__ import annotations

import numpy as np
import torch


def _take_frames(clip: torch.Tensor, indices) -> torch.Tensor:
    return clip.index_select(0, torch.as_tensor(np.asarray(indices), dtype=torch.long, device=clip.device))


def select_frame_indices(num_frames: int, n: int) -> np.ndarray:
    """Stride-subsample indices: step = max(T//n, 1), first n of every
    step-th frame (reference select_frames train.py:132-145).  For clips
    shorter than n the reference under-fills; this cycles (idx % T) so the
    output length is always n."""
    step = max(num_frames // n, 1)
    idx = np.arange(n) * step
    return idx % num_frames


def select_frames(clip: torch.Tensor, n: int) -> torch.Tensor:
    return _take_frames(clip, select_frame_indices(int(clip.shape[0]), n))


def temporal_begin_crop(clip: torch.Tensor, size: int) -> torch.Tensor:
    """The first `size` frames, cycled when short (vidaug temporal.py:28-49)."""
    return _take_frames(clip, np.arange(size) % min(int(clip.shape[0]), size))


def temporal_center_crop(clip: torch.Tensor, size: int) -> torch.Tensor:
    """The centered `size` frames, cycled when short (vidaug temporal.py:52-77)."""
    t = int(clip.shape[0])
    begin = max(0, t // 2 - size // 2)
    return _take_frames(clip, begin + np.arange(size) % (min(begin + size, t) - begin))


def temporal_crop_at(clip: torch.Tensor, size: int, begin: int) -> torch.Tensor:
    """`size` frames from `begin`, cycled past the end."""
    span = min(begin + size, int(clip.shape[0])) - begin
    return _take_frames(clip, begin + np.arange(size) % span)


def temporal_random_crop(clip: torch.Tensor, size: int, generator: torch.Generator) -> torch.Tensor:
    """A random `size`-frame window, begin ∈ [0, max(0, T−size−1)]
    (vidaug temporal.py:80-105)."""
    rand_end = max(0, int(clip.shape[0]) - size - 1)
    begin = int(torch.randint(0, rand_end + 1, (), generator=generator, device=generator.device))
    return temporal_crop_at(clip, size, begin)


def inverse_order(clip: torch.Tensor) -> torch.Tensor:
    """The full temporal reverse."""
    return torch.flip(clip, dims=(0,))


def _linspace_resample_indices(num_frames: int, out_frames: int) -> np.ndarray:
    """vidaug's resample recipe `int(linspace(1, T, n)) − 1`
    (temporal.py:119-175): truncating cast, 1-based, inclusive ends."""
    return np.linspace(1, num_frames, out_frames).astype(np.int64) - 1


def downsample(clip: torch.Tensor, ratio: float) -> torch.Tensor:
    """ratio ∈ [0, 1] (vidaug temporal.py:119-137)."""
    t = int(clip.shape[0])
    return _take_frames(clip, _linspace_resample_indices(t, int(np.floor(ratio * t))))


def upsample(clip: torch.Tensor, ratio: float) -> torch.Tensor:
    """ratio > 1 (vidaug temporal.py:140-156)."""
    t = int(clip.shape[0])
    return _take_frames(clip, _linspace_resample_indices(t, int(np.floor(ratio * t))))


def temporal_fit(clip: torch.Tensor, size: int) -> torch.Tensor:
    """Resample to exactly `size` frames (vidaug temporal.py:159-175)."""
    return _take_frames(clip, _linspace_resample_indices(int(clip.shape[0]), size))


def temporal_elastic_indices(num_frames: int, inverse: bool, u: float) -> torch.Tensor:
    """The tanh/atanh time warp's frame indices (vidaug temporal.py:178-214),
    in float32: scale = 0.6 + 0.21·u with `inverse` (atanh), else
    0.8 + 0.6·u (tanh), over linspace(−scale, scale, T), normalised by the
    last value and mapped to [0, T−1] with round-half-even (JAX's
    float32 arithmetic, so the indices are equal)."""
    if num_frames == 1:
        return torch.zeros(1, dtype=torch.long)
    u = torch.tensor(u, dtype=torch.float32)
    scale = u * 0.21 + 0.6 if inverse else u * 0.6 + 0.8
    # jnp.linspace's formula: start·(1 − s) + stop·s at s = i/(T−1), then stop
    step = torch.arange(num_frames - 1, dtype=torch.float32) / (num_frames - 1)
    xs = torch.cat([-scale * (1 - step) + scale * step, scale[None]])
    vals = torch.atanh(xs) if inverse else torch.tanh(xs)
    vals = vals / vals[-1]
    return torch.round(((vals + 1.0) / 2.0) * (num_frames - 1)).long()


def temporal_elastic_transformation(clip: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """tanh/atanh time warping with a fair coin for the inverse form and
    u ~ U[0, 1)."""
    draws = torch.rand(2, generator=generator, device=generator.device).tolist()
    idx = temporal_elastic_indices(int(clip.shape[0]), draws[0] < 0.5, draws[1])
    return clip.index_select(0, idx.to(clip.device))

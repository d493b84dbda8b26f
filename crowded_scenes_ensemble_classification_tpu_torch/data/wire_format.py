"""Device-side I420 decode of resident clip rows.

Counterpart of `crowded_scenes_ensemble_classification_tpu/data/wire_format.py`
(`i420_to_bgr_u8`, lines 387-405).  Only the decode is ported: the wire
plan/pack/unpack was built for a slow host link and is left out.
"""

from __future__ import annotations

import torch


def i420_to_bgr_u8(flat_u8: torch.Tensor, frames: int, h: int, w: int) -> torch.Tensor:
    """Flat I420 bytes → u8 BGR.  `flat_u8` is (..., frames·h·w·3/2); the
    result is (..., frames, h, w, 3).  Nearest 2×2 chroma upsample and
    studio-swing BT.601 with cv2's Q20 constants, rounded half to even —
    the JAX function's float32 arithmetic, step for step."""
    lead = flat_u8.shape[:-1]
    fr = flat_u8.reshape(*lead, frames, h * 3 // 2, w).to(torch.float32)
    y = fr[..., :h, :]
    chroma = fr[..., h:, :].reshape(*lead, frames, 2, h // 2, w // 2)
    up = chroma.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    u = up[..., 0, :, :] - 128.0
    v = up[..., 1, :, :] - 128.0
    yy = 1.1640625 * torch.clamp_min(y - 16.0, 0.0)
    b = yy + 2.0178222656 * u
    g = yy - 0.3909912109 * u - 0.8129882812 * v
    r = yy + 1.5959472656 * v
    bgr = torch.stack([b, g, r], dim=-1)
    return torch.clamp(torch.round(bgr), 0.0, 255.0).to(torch.uint8)

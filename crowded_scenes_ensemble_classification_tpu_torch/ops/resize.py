"""Batched bilinear resize and fused crop-and-resize.

Counterpart of `crowded_scenes_ensemble_classification_tpu/ops/resize.py`
(cv2 INTER_LINEAR semantics: half-pixel centers, edge clamp, no
antialiasing).  The JAX functions take one clip and are vmapped; these take
a batch (B, T, H, W, C) with per-clip window starts, sizes and flips as
tensors, and gather along H then W.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _axis_coords(out_size: int, win_size: torch.Tensor, win_start: torch.Tensor,
                 flip: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, out_size) half-pixel source coordinates sampling `out_size`
    pixels from the windows [win_start, win_start + win_size) (JAX
    resize.py:34-43)."""
    win_size = win_size.reshape(-1, 1)
    scale = win_size / out_size
    coords = (torch.arange(out_size, dtype=torch.float32, device=win_size.device) + 0.5) * scale - 0.5
    if flip is not None:
        coords = torch.where(flip.reshape(-1, 1), (win_size - 1.0) - coords, coords)
    coords = torch.minimum(torch.clamp_min(coords, 0.0), win_size - 1.0)
    return coords + win_start.reshape(-1, 1)


def _gather_lerp(x: torch.Tensor, coords: torch.Tensor, dim: int) -> torch.Tensor:
    """Bilinear interpolation of (B, ...) along `dim` at per-clip coords
    (B, n) (JAX resize.py:46-57)."""
    n = x.shape[dim]
    c0 = torch.clamp(torch.floor(coords), 0, n - 1)
    c1 = torch.clamp(c0 + 1, 0, n - 1)
    w = torch.clamp(coords - c0, 0.0, 1.0)
    shape = [1] * x.dim()
    shape[0], shape[dim] = coords.shape
    x0 = torch.take_along_dim(x, c0.long().reshape(shape), dim=dim)
    x1 = torch.take_along_dim(x, c1.long().reshape(shape), dim=dim)
    w = w.reshape(shape)
    return x0 * (1.0 - w) + x1 * w


def crop_resize(
    clips: torch.Tensor,
    out_hw: Tuple[int, int],
    win_start_yx: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    win_size_hw: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    flip_x: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sample (out_h, out_w) from the window [y0, y0+wh) × [x0, x0+ww) of
    every frame of every clip, mirrored in x where `flip_x`.

    clips (B, T, H, W, C); starts and sizes are (B,) float tensors (None:
    the whole frame); flip_x (B,) bool.  Returns float32 (B, T, oh, ow, C)."""
    b, _, h, w, _ = clips.shape
    dev = clips.device
    full = lambda n: torch.full((b,), float(n), dtype=torch.float32, device=dev)  # noqa: E731
    zero = torch.zeros(b, dtype=torch.float32, device=dev)
    y0, x0 = win_start_yx if win_start_yx is not None else (zero, zero)
    wh, ww = win_size_hw if win_size_hw is not None else (full(h), full(w))
    clips = clips.to(torch.float32)
    ys = _axis_coords(out_hw[0], wh.float(), y0.float(), None)
    xs = _axis_coords(out_hw[1], ww.float(), x0.float(), flip_x)
    out = _gather_lerp(clips, ys, dim=2)
    return _gather_lerp(out, xs, dim=3)


def resize_bilinear(clips: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Resize (B, T, H, W, C) → (B, T, out_h, out_w, C), cv2 INTER_LINEAR."""
    return crop_resize(clips, out_hw)

"""Affine warps (vidaug/augmentors/affine.py equivalents).

Counterpart of `crowded_scenes_ensemble_classification_tpu/ops/affine.py`
(lines 1-160) on float (T, H, W, C) tensors: one inverse-mapped bilinear
warp drives rotate, translate, shear and scale, in float32 with the JAX
package's conventions (cv2.warpAffine's forward matrix with the origin at
the top-left for translate and shear, rotation about the frame center,
zero fill; `scale` keeps the canvas, as there).  Each `random_*` variant
draws its parameters from a `torch.Generator` and calls the deterministic
core of the same name.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _f32(value, device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32, device=device)


def sample_bilinear(clip: torch.Tensor, src_y: torch.Tensor, src_x: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """Sample every frame of (T, H, W, C) at real source coordinates
    (H_out, W_out); a coordinate outside [0, H−1] × [0, W−1] gives `fill`."""
    t, h, w, c = clip.shape
    flat = clip.float().reshape(t, h * w, c)
    y0, x0 = torch.floor(src_y), torch.floor(src_x)
    wy, wx = (src_y - y0)[None, :, :, None], (src_x - x0)[None, :, :, None]

    def gather(yy, xx):
        idx = (torch.clamp(yy, 0, h - 1).long() * w + torch.clamp(xx, 0, w - 1).long()).reshape(-1)
        return flat[:, idx].reshape(t, *src_y.shape, c)

    out = (gather(y0, x0) * (1 - wy) * (1 - wx) + gather(y0, x0 + 1) * (1 - wy) * wx
           + gather(y0 + 1, x0) * wy * (1 - wx) + gather(y0 + 1, x0 + 1) * wy * wx)
    valid = (src_y >= 0) & (src_y <= h - 1) & (src_x >= 0) & (src_x <= w - 1)
    return torch.where(valid[None, :, :, None], out, _f32(fill, clip.device))


def _dst_grid(out_hw: Tuple[int, int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    ys = torch.arange(out_hw[0], dtype=torch.float32, device=device)
    xs = torch.arange(out_hw[1], dtype=torch.float32, device=device)
    return torch.meshgrid(ys, xs, indexing="ij")


def warp_affine_inverse(clip: torch.Tensor, inv_mat, out_hw: Optional[Tuple[int, int]] = None,
                        fill: float = 0.0) -> torch.Tensor:
    """Warp with a 2×3 matrix mapping DST (x, y, 1) → SRC (x, y)."""
    if out_hw is None:
        out_hw = (int(clip.shape[1]), int(clip.shape[2]))
    gy, gx = _dst_grid(out_hw, clip.device)
    m = _f32(inv_mat, clip.device)
    src_x = m[0, 0] * gx + m[0, 1] * gy + m[0, 2]
    src_y = m[1, 0] * gx + m[1, 1] * gy + m[1, 2]
    return sample_bilinear(clip, src_y, src_x, fill)


def _invert_2x3(m: torch.Tensor) -> torch.Tensor:
    """Invert a forward affine [[a, b, tx], [c, d, ty]] (src → dst) to dst → src."""
    (a, b, tx), (c, d, ty) = m[0], m[1]
    det = a * d - b * c
    ia, ib, ic, id_ = d / det, -b / det, -c / det, a / det
    return torch.stack([torch.stack([ia, ib, -(ia * tx + ib * ty)]), torch.stack([ic, id_, -(ic * tx + id_ * ty)])])


def rotate(clip: torch.Tensor, angle_deg, fill: float = 0.0) -> torch.Tensor:
    """Rotate about the frame center by `angle_deg` (counter-clockwise, the
    image convention of scipy imrotate)."""
    h, w = int(clip.shape[1]), int(clip.shape[2])
    theta = torch.deg2rad(_f32(angle_deg, clip.device))
    cos, sin = torch.cos(theta), torch.sin(theta)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    gy, gx = _dst_grid((h, w), clip.device)
    dx, dy = gx - cx, gy - cy
    return sample_bilinear(clip, sin * dx + cos * dy + cy, cos * dx - sin * dy + cx, fill)


def _uniform(generator: torch.Generator, low: float, high: float) -> float:
    return float(torch.rand((), generator=generator, device=generator.device)) * (high - low) + low


def _randint(generator: torch.Generator, low: int, high: int) -> int:
    return int(torch.randint(low, high, (), generator=generator, device=generator.device))


def random_rotate(clip: torch.Tensor, generator: torch.Generator, degrees: Tuple[float, float]) -> torch.Tensor:
    """angle ~ U[degrees] (vidaug affine.py:25-59)."""
    return rotate(clip, _uniform(generator, *degrees))


def translate(clip: torch.Tensor, x_move, y_move, fill: float = 0.0) -> torch.Tensor:
    """Shift the content by (+x, +y) pixels, zero fill (vidaug affine.py:111-139)."""
    gy, gx = _dst_grid((int(clip.shape[1]), int(clip.shape[2])), clip.device)
    return sample_bilinear(clip, gy - _f32(y_move, clip.device), gx - _f32(x_move, clip.device), fill)


def random_translate(clip: torch.Tensor, generator: torch.Generator, x: int, y: int) -> torch.Tensor:
    """x_move ∈ [−x, x], y_move ∈ [−y, y], whole pixels."""
    x_move = _randint(generator, -x, x + 1)
    return translate(clip, float(x_move), float(_randint(generator, -y, y + 1)))


def shear(clip: torch.Tensor, x_shear, y_shear, fill: float = 0.0) -> torch.Tensor:
    """Forward matrix [[1, sx, 0], [sy, 1, 0]], origin top-left (vidaug
    affine.py:142-170)."""
    sx, sy = _f32(x_shear, clip.device), _f32(y_shear, clip.device)
    one, zero = torch.ones_like(sx), torch.zeros_like(sx)
    fwd = torch.stack([torch.stack([one, sx, zero]), torch.stack([sy, one, zero])])
    return warp_affine_inverse(clip, _invert_2x3(fwd), fill=fill)


def random_shear(clip: torch.Tensor, generator: torch.Generator, x: float, y: float) -> torch.Tensor:
    sx = _uniform(generator, -x, x)
    return shear(clip, sx, _uniform(generator, -y, y))


def scale(clip: torch.Tensor, factor, fill: float = 0.0) -> torch.Tensor:
    """Zoom about the top-left origin by `factor` (content scaled, canvas fixed)."""
    gy, gx = _dst_grid((int(clip.shape[1]), int(clip.shape[2])), clip.device)
    f = _f32(factor, clip.device)
    return sample_bilinear(clip, gy / f, gx / f, fill)


def random_resize(clip: torch.Tensor, generator: torch.Generator, rate: float) -> torch.Tensor:
    """factor ~ U[1−rate, 1+rate] (vidaug affine.py:62-108), canvas fixed."""
    return scale(clip, _uniform(generator, 1.0 - rate, 1.0 + rate))

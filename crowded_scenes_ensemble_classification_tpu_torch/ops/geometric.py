"""Geometric and texture transforms (vidaug/augmentors/geometric.py equivalents).

Counterpart of `crowded_scenes_ensemble_classification_tpu/ops/geometric.py`
(lines 1-205) on float (T, H, W, C) tensors:

- `gaussian_blur`: separable blur over H and W with scipy's kernel
  (truncate 4) and edge ('nearest') padding; `blur_channels=True` also
  blurs across channels, the reference's scalar-sigma behaviour
  (geometric.py:40);
- `elastic_transformation`: a smoothed random displacement field per frame
  (geometric.py:95-120), zero-padded smoothing (scipy mode='constant'),
  bilinear sampling;
- `piecewise_affine_transform`: one blurred integer displacement map for the
  whole clip (geometric.py:140-185), nearest gather;
- superpixels: SLIC of the time-mean frame on the host (skimage, imported
  inside `superpixel_segments_host`), then each chosen segment replaced by
  its per-frame mean, a segment sum by `index_add_` on the clip's device
  (geometric.py:189-249).

Each random transform draws its noise from a `torch.Generator` and calls a
deterministic core that takes the noise as arguments (`*_from_noise`,
`apply_superpixels_from_choice`).
"""

from __future__ import annotations

import numpy as np
import torch

from .affine import sample_bilinear


def _gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _conv_axis(x: torch.Tensor, kernel: np.ndarray, dim: int, edge: bool = True) -> torch.Tensor:
    """Correlate `x` with a 1-D kernel along `dim`, keeping its size: edge
    padding ('nearest'), or zeros with edge=False (scipy mode='constant')."""
    r = (len(kernel) - 1) // 2
    if r == 0:
        return x * float(kernel[0])
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = r
    if edge:
        pad_lo, pad_hi = x.narrow(dim, 0, 1).expand(shape), x.narrow(dim, n - 1, 1).expand(shape)
    else:
        pad_lo = pad_hi = x.new_zeros(shape)
    xp = torch.cat([pad_lo, x, pad_hi], dim=dim)
    out = xp.narrow(dim, 0, n) * float(kernel[0])
    for i in range(1, len(kernel)):
        out = out + xp.narrow(dim, i, n) * float(kernel[i])
    return out


def gaussian_blur(clip: torch.Tensor, sigma: float, blur_channels: bool = False) -> torch.Tensor:
    """Per-frame Gaussian blur (vidaug geometric.py:26-45)."""
    if sigma <= 0:
        return clip
    k = _gaussian_kernel1d(sigma)
    out = _conv_axis(_conv_axis(clip.float(), k, 1), k, 2)
    return _conv_axis(out, k, 3) if blur_channels else out


def smoothed_field(u: torch.Tensor, sigma: float, alpha: float) -> torch.Tensor:
    """gaussian_filter(u, sigma, mode='constant') · alpha of a (H, W) noise
    map, the displacement recipe of vidaug geometric.py:114-117."""
    if sigma <= 0:
        return u * alpha
    k = _gaussian_kernel1d(sigma)
    return _conv_axis(_conv_axis(u, k, 0, edge=False), k, 1, edge=False) * alpha


def _uniform(generator: torch.Generator, shape, low: float, high: float, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device) * (high - low) + low
    return u.to(device)


def elastic_from_noise(clip: torch.Tensor, u_y: torch.Tensor, u_x: torch.Tensor, alpha: float = 0.0,
                       sigma: float = 0.0, cval: float = 0.0) -> torch.Tensor:
    """Warp frame t by the displacement fields smoothed from its U(−1, 1)
    noise maps u_y[t], u_x[t] (each (T, H, W))."""
    t, h, w, _ = clip.shape
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=clip.device),
                            torch.arange(w, dtype=torch.float32, device=clip.device), indexing="ij")
    frames = [sample_bilinear(clip[i:i + 1].float(), gy + smoothed_field(u_y[i], sigma, alpha),
                              gx + smoothed_field(u_x[i], sigma, alpha), fill=cval)
              for i in range(t)]
    return torch.cat(frames, 0)


def elastic_transformation(clip: torch.Tensor, generator: torch.Generator, alpha: float = 0.0, sigma: float = 0.0,
                           cval: float = 0.0) -> torch.Tensor:
    """Per-frame elastic warp (vidaug geometric.py:48-136), noise U(−1, 1)."""
    t, h, w, _ = clip.shape
    u = _uniform(generator, (2, t, h, w), -1.0, 1.0, clip.device)
    return elastic_from_noise(clip, u[0], u[1], alpha, sigma, cval)


def _gauss_blur_2d(img: torch.Tensor, sigma: float) -> torch.Tensor:
    if sigma <= 0:
        return img
    k = _gaussian_kernel1d(sigma)
    return _conv_axis(_conv_axis(img, k, 0), k, 1)


def piecewise_affine_from_noise(clip: torch.Tensor, u_r: torch.Tensor, u_c: torch.Tensor,
                                displacement_kernel: float = 0.0,
                                displacement_magnification: float = 0.0) -> torch.Tensor:
    """Gather every frame through the integer row and column displacement
    maps floor(blur(u) · magnification · kernel) of the (H, W) noise maps
    u_r, u_c (vidaug geometric.py:140-185)."""
    t, h, w, c = clip.shape
    sigma = max(displacement_kernel, 1e-6)
    mag = displacement_magnification * displacement_kernel
    disp = lambda u: torch.floor(_gauss_blur_2d(u.float(), sigma) * mag).long()  # noqa: E731
    rows = torch.clamp(disp(u_r) + torch.arange(h, device=clip.device)[:, None], 0, h - 1)
    cols = torch.clamp(disp(u_c) + torch.arange(w, device=clip.device)[None, :], 0, w - 1)
    return clip.reshape(t, h * w, c)[:, (rows * w + cols).reshape(-1)].reshape(t, h, w, c)


def piecewise_affine_transform(clip: torch.Tensor, generator: torch.Generator, displacement: float = 0.0,
                               displacement_kernel: float = 0.0,
                               displacement_magnification: float = 0.0) -> torch.Tensor:
    """Noise maps U(−displacement, displacement) for rows and columns."""
    _, h, w, _ = clip.shape
    u = _uniform(generator, (2, h, w), -displacement, displacement, clip.device)
    return piecewise_affine_from_noise(clip, u[0], u[1], displacement_kernel, displacement_magnification)


def superpixel_segments_host(mean_frame: np.ndarray, n_segments: int) -> np.ndarray:
    """SLIC labels of the time-mean frame (host; skimage)."""
    from skimage import segmentation

    return segmentation.slic(mean_frame.astype(np.float64), n_segments=n_segments, compactness=10).astype(np.int32)


def apply_superpixels_from_choice(clip: torch.Tensor, segments: torch.Tensor, replace: torch.Tensor) -> torch.Tensor:
    """Replace the pixels of the segments where `replace` ((S,) bool) by
    their segment's mean in each frame; segments (H, W) int labels 0..S−1."""
    t, h, w, c = clip.shape
    seg = segments.reshape(-1).long().to(clip.device)
    num_seg = replace.shape[0]
    flat = clip.float().reshape(t, h * w, c)
    counts = torch.zeros(num_seg, device=clip.device).index_add_(0, seg, torch.ones(h * w, device=clip.device))
    sums = torch.zeros(t, num_seg, c, device=clip.device).index_add_(1, seg, flat)
    means = sums / torch.clamp(counts, min=1.0)[None, :, None]
    rep = replace.to(clip.device)[seg]
    return torch.where(rep[None, :, None], means[:, seg], flat).reshape(t, h, w, c)


def apply_superpixels(clip: torch.Tensor, segments: torch.Tensor, p_replace: float,
                      generator: torch.Generator) -> torch.Tensor:
    """Each segment replaced with probability `p_replace` (the reference
    replaced where its tiled p_replace sample was 1)."""
    num_seg = int(segments.max()) + 1
    replace = torch.rand(num_seg, generator=generator, device=generator.device) < p_replace
    return apply_superpixels_from_choice(clip, segments, replace)

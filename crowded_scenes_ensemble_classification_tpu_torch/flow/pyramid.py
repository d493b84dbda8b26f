"""Image pyramids, separable correlations and warps for the dense-flow solvers.

Counterpart of `crowded_scenes_ensemble_classification_tpu/flow/pyramid.py`.
The JAX functions take one (H, W) image and are vmapped; these take a flat
batch (N, H, W), and the warps also a channel-packed (N, C, H, W) stack
whose channels share one displacement field.  Flow fields keep the JAX
layout, (N, H, W, 2) with [..., 0] = u (x) and [..., 1] = v (y).

The correlations are shifted-slice multiplies and adds in float32, one
tap after another, never a convolution: a float32 convolution on the card
goes through cuDNN in TF32 by default, about 1e-3 relative, which the
Farnebäck 2×2 solve amplifies.  Multiplies and adds stay separate
operations, so no fused multiply-add rounds differently on the vector
body and the tail of a loop, and a pair's result does not depend on the
size of the batch it runs in.

The JAX package's two production warps are TPU workarounds for slow
gathers.  Their functions are ported, not their form:

- `warp_image_mxu` (JAX :144-235) is exact bilinear resampling at positions
  clamped to ±max_disp and then to the image, written there as one-hot
  matmuls on the MXU.  Here it is a 4-tap gather with the same
  select-based weights 1−wx / wx and the same factored order
  top·(1−wy) + bottom·wy (JAX :139-141, :197-203, :225-230).
- `warp_image_separable` (JAX :247-285) sums 2·max_disp+1 shifted copies
  per axis, of which only two hat weights are non-zero.  Here it is a
  2-tap gather per axis, y first and then x on the y-warped image, with
  both weights computed as there, max(0, 1 − |v − d|), added in
  increasing-d order, and edge replication as index clamping.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

PYR_DOWN_KERNEL = np.asarray([1, 4, 6, 4, 1], np.float32) / 16.0  # JAX pyramid.py:82

def _real(value) -> bool:
    """Whether a tensor, or every tensor of nested lists and tuples, is a
    plain tensor with storage (no fake or functional stand-in)."""
    if isinstance(value, torch.Tensor):
        return type(value) is torch.Tensor
    return all(_real(v) for v in value)


def _device_cache(make):
    """`functools.cache` for a function of hashable arguments that makes
    tensors on a device (a fresh host-to-device copy each call would stall
    the card's queue), except that it keeps only real tensors.  While a
    program is traced (`torch.export`, `torch.compile`) a miss makes fake
    stand-ins: the trace takes them as its constants, and kept, they would
    reach the eager calls after it."""
    cache: Dict[tuple, object] = {}

    @functools.wraps(make)
    def cached(*args):
        hit = cache.get(args)
        if hit is None:
            hit = make(*args)
            if _real(hit):
                cache[args] = hit
        return hit

    return cached


@_device_cache
def _const_from_bytes(dtype: str, shape: tuple, data: bytes, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(data, dtype).reshape(shape).copy()).to(device)


def _const(values: np.ndarray, device: torch.device) -> torch.Tensor:
    """A small float32 or int64 constant on `device`, made once per device."""
    values = np.ascontiguousarray(values)
    return _const_from_bytes(values.dtype.str, values.shape, values.tobytes(), device)


def _edge_pad(x: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """Pad `dim` by r on both sides, replicating the edge values."""
    if r == 0:
        return x
    return x.index_select(dim, _edge_index(x.shape[dim], r, x.device))


@_device_cache
def _edge_index(n: int, r: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.clip(np.arange(-r, n + r), 0, n - 1)).to(device)


def _correlate(x: torch.Tensor, taps: Sequence, dim: int) -> torch.Tensor:
    """1-D correlation along `dim`, edge-replicated borders, taps summed in
    order.  Each tap is a float or a tensor broadcast against x (per-channel
    weights)."""
    r = (len(taps) - 1) // 2
    n = x.shape[dim]
    xp = _edge_pad(x, r, dim)
    acc = xp.narrow(dim, 0, n) * taps[0]
    for i in range(1, len(taps)):
        acc += xp.narrow(dim, i, n) * taps[i]
    return acc


def _float_taps(kernel) -> List[float]:
    return [float(v) for v in np.asarray(kernel, np.float32)]


def _channel_taps(stack: np.ndarray, device: torch.device) -> List[torch.Tensor]:
    """(C, k) per-channel kernels → k weights of shape (1, C, 1, 1)."""
    stack = np.asarray(stack, np.float32)
    return [_const(stack[:, i].reshape(1, -1, 1, 1), device) for i in range(stack.shape[1])]


def _sep_conv2d(img: torch.Tensor, ky, kx) -> torch.Tensor:
    """Separable 2-D correlation of (..., H, W) images with edge-replicated
    borders: the y taps, then the x taps (JAX pyramid.py:20-36)."""
    return _correlate(_correlate(img.float(), _float_taps(ky), -2), _float_taps(kx), -1)


def _sep_conv2d_multi(x: torch.Tensor, ky_stack: np.ndarray, kx_stack: np.ndarray) -> torch.Tensor:
    """Depthwise separable correlation of a channels-leading (N, C, H, W)
    stack: channel c with (ky_stack[c], kx_stack[c]) (JAX pyramid.py:39-61,
    which takes channels-last (H, W, C))."""
    x = x.float()
    return _correlate(_correlate(x, _channel_taps(ky_stack, x.device), -2), _channel_taps(kx_stack, x.device), -1)


def gaussian_kernel(sigma: float, radius: int | None = None) -> np.ndarray:
    if radius is None:
        radius = int(4.0 * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def box_kernel(size: int) -> np.ndarray:
    return (np.ones(size) / size).astype(np.float32)


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """5-tap Gaussian blur, then keep every other row and column from the
    first (the ceiling on odd sizes), as cv2.pyrDown (JAX pyramid.py:80-84)."""
    return _sep_conv2d(img, PYR_DOWN_KERNEL, PYR_DOWN_KERNEL)[..., ::2, ::2].contiguous()


def build_pyramid(img: torch.Tensor, levels: int, min_size: int = 16) -> List[torch.Tensor]:
    """[level 0 = full resolution, level 1 = /2, ...], stopping before a
    level whose smaller side would fall under `min_size` (JAX :87-95)."""
    pyr = [img]
    for _ in range(1, levels):
        h, w = pyr[-1].shape[-2:]
        if min(h, w) // 2 < min_size:
            break
        pyr.append(pyr_down(pyr[-1]))
    return pyr


@functools.lru_cache(maxsize=None)
def _resize_taps(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """The weights of `jax.image.resize(..., method="linear")` along one
    axis (antialiased triangle kernel, half-pixel centres, each output's
    weights normalised to sum 1, outputs whose sample lies outside the input
    zeroed: jax/_src/image/scale.py `compute_weight_mat`), computed in
    float32 as there and kept as its non-zero taps → (index, weight), each
    (K, out_size), in increasing input index."""
    f32 = np.float32
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * f32(inv_scale) - f32(0.0) - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0), f32(1) - np.abs(x)).astype(f32)
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                       weights / np.where(total != 0, total, f32(1)), f32(0)).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    weights = np.where(inside[None, :], weights, f32(0))
    k = max(1, int((weights != 0).sum(axis=0).max()))
    index = np.zeros((k, out_size), np.int64)
    taps = np.zeros((k, out_size), f32)
    for j in range(out_size):
        nz = np.flatnonzero(weights[:, j])
        index[: len(nz), j] = nz
        taps[: len(nz), j] = weights[nz, j]
    return index, taps


@_device_cache
def _resize_weights(in_size: int, out_size: int, ndim: int, dim: int, device: torch.device) -> list:
    """`_resize_taps` on `device`, each weight shaped to broadcast along `dim`."""
    shape = [1] * ndim
    shape[dim] = out_size
    return [(torch.from_numpy(idx).to(device), torch.from_numpy(w.reshape(shape)).to(device))
            for idx, w in zip(*_resize_taps(in_size, out_size))]


def _resize_axis(x: torch.Tensor, out_size: int, dim: int) -> torch.Tensor:
    in_size = x.shape[dim]
    if in_size == out_size:  # jax.image.resize skips an axis that keeps its size
        return x
    acc = None
    for idx, w in _resize_weights(in_size, out_size, x.dim(), dim, x.device):
        term = x.index_select(dim, idx) * w
        acc = term if acc is None else acc + term
    return acc


def upsample_flow(flow: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(N, h, w, 2) → (N, out_h, out_w, 2) by `jax.image.resize(...,
    "linear")` (not cv2's INTER_LINEAR), displacements rescaled by the
    size ratios (JAX pyramid.py:102-108)."""
    h, w = flow.shape[-3:-1]
    scale = np.asarray([out_hw[1] / w, out_hw[0] / h], np.float32)  # [x, y]
    up = _resize_axis(_resize_axis(flow.float(), out_hw[0], -3), out_hw[1], -2)
    return up * _const(scale, flow.device)


def _channels_leading(img: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """(N, H, W) → (N, 1, H, W) and True; (N, C, H, W) unchanged and False."""
    return (img.unsqueeze(1), True) if img.dim() == 3 else (img, False)


def _bilinear(img: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor) -> torch.Tensor:
    """Sample (N, C, H, W) at per-pixel positions (N, H, W) already inside
    the image: 4 gathers, select-based weights, x-lerp then y-lerp."""
    n, c, h, w = img.shape
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = (sx - x0).unsqueeze(1), (sy - y0).unsqueeze(1)
    xi0, yi0 = x0.long(), y0.long()
    xi1, yi1 = (xi0 + 1).clamp_(max=w - 1), (yi0 + 1).clamp_(max=h - 1)
    flat = img.reshape(n, c, h * w)

    def gather(yy, xx):
        idx = (yy * w + xx).reshape(n, 1, h * w).expand(n, c, h * w)
        return flat.gather(2, idx).reshape(n, c, h, w)

    top = gather(yi0, xi0) * (1 - wx) + gather(yi0, xi1) * wx
    bottom = gather(yi1, xi0) * (1 - wx) + gather(yi1, xi1) * wx
    return top * (1 - wy) + bottom * wy


def _sample_positions(flow: torch.Tensor, h: int, w: int, max_disp: float | None):
    gx = torch.arange(w, dtype=torch.float32, device=flow.device)
    gy = torch.arange(h, dtype=torch.float32, device=flow.device).unsqueeze(1)
    u, v = flow[..., 0], flow[..., 1]
    if max_disp is not None:
        u, v = u.clamp(-max_disp, max_disp), v.clamp(-max_disp, max_disp)
    return (gx + u).clamp_(0.0, w - 1.0), (gy + v).clamp_(0.0, h - 1.0)


def warp_image(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Sample img at (x + u, y + v), positions clamped to the image,
    bilinear (JAX pyramid.py:111-141).  img (N, H, W) or (N, C, H, W)."""
    x, squeeze = _channels_leading(img.float())
    sx, sy = _sample_positions(flow, x.shape[-2], x.shape[-1], None)
    out = _bilinear(x, sx, sy)
    return out[:, 0] if squeeze else out


def warp_image_mxu(img: torch.Tensor, flow: torch.Tensor, max_disp: int = 16) -> torch.Tensor:
    """Exact bilinear warp with displacements clamped to ±max_disp, then to
    the image (JAX pyramid.py:144-235): a 4-tap gather here.  img (N, H, W)
    or channels-leading (N, C, H, W); every channel shares the field."""
    x, squeeze = _channels_leading(img.float())
    sx, sy = _sample_positions(flow, x.shape[-2], x.shape[-1], max_disp)
    out = _bilinear(x, sx, sy)
    return out[:, 0] if squeeze else out


def image_gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central-difference (∂x, ∂y) with edge replication (JAX :238-244)."""
    xp = _edge_pad(img, 1, -1)
    yp = _edge_pad(img, 1, -2)
    return (xp[..., 2:] - xp[..., :-2]) * 0.5, (yp[..., 2:, :] - yp[..., :-2, :]) * 0.5


def _shift_pass(img: torch.Tensor, disp: torch.Tensor, dim: int) -> torch.Tensor:
    """Σ_d max(0, 1 − |disp − d|) · img[index + d] along `dim` (3: W, 2: H)
    of (N, C, H, W), over the two d that can weigh: floor(disp) and
    floor(disp) + 1, indices clamped to the image."""
    n, c, h, w = img.shape
    size = img.shape[dim]
    d_lo = torch.floor(disp)
    d_hi = d_lo + 1
    pos = torch.arange(size, device=img.device)
    pos = pos if dim == 3 else pos.unsqueeze(1)
    weights = []
    for d in (d_lo, d_hi):
        idx = (pos + d.long()).clamp_(0, size - 1).unsqueeze(1).expand(n, c, h, w)
        weights.append((torch.clamp_min(1.0 - torch.abs(disp - d), 0.0).unsqueeze(1), img.gather(dim, idx)))
    (w_lo, v_lo), (w_hi, v_hi) = weights
    return w_lo * v_lo + w_hi * v_hi


def warp_image_separable(img: torch.Tensor, flow: torch.Tensor, max_disp: int = 16) -> torch.Tensor:
    """Separable approximation of the bilinear warp: a y pass with each
    target pixel's v, then an x pass with its u on the y-warped image,
    displacements clamped to ±max_disp (JAX pyramid.py:247-285).  Exact for
    uniform motion.  img (N, H, W) or channels-leading (N, C, H, W)."""
    x, squeeze = _channels_leading(img.float())
    u = flow[..., 0].clamp(-max_disp, max_disp)
    v = flow[..., 1].clamp(-max_disp, max_disp)
    out = _shift_pass(_shift_pass(x, v, 2), u, 3)
    return out[:, 0] if squeeze else out

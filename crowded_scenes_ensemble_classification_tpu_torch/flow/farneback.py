"""Dense Farnebäck optical flow on the card, over flat batches of pairs.

Counterpart of `crowded_scenes_ensemble_classification_tpu/flow/farneback.py`,
the reference's per-pair cv2.calcOpticalFlowFarneback (train.py:294-332)
with its parameters.  Per pyramid level, coarse to fine: a local quadratic
fit of each frame (six separable Gaussian-weighted moments and a constant
6×6 solve), then `iterations` displacement updates, each a warp of the
second frame by the current flow, its quadratic fit, and a per-pixel 2×2
solve over a winsize box average.

The JAX solver takes one pair and is vmapped; here every function takes
a flat batch (N, H, W), so anything per pair is per row of the batch.  It
is plain PyTorch on tensors, as the JAX original is XLA code with no Pallas
kernel.  Every correlation is shifted-slice float32 arithmetic and the 6×6
solve is written out as multiplies and adds (`pyramid.py`), so neither
cuDNN's TF32 convolutions nor a TF32 matmul setting reaches the flow.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

from ..ops.resize import crop_resize
from .pyramid import (
    _channel_taps,
    _const,
    _correlate,
    _float_taps,
    box_kernel,
    build_pyramid,
    upsample_flow,
    warp_image_mxu,
    warp_image_separable,
)

# JAX farneback.py:51-53 (reference call train.py:322-324).
REFERENCE_PARAMS = dict(pyr_scale=0.5, levels=5, winsize=11, iterations=5, poly_n=5, poly_sigma=1.1)
# JAX farneback.py:65-67: the EPE-gated throughput schedule (one residual
# pass at the three finest levels; the coarsest keeps the full schedule).
TURBO_PARAMS = dict(fast_warp=True, fine_iterations=1, fine_max_disp=4, fine_levels=3)
FLOW_CHUNK_PAIRS = 80  # JAX farneback.py:75: pairs per chunk of farneback_flow_batch
FLOW_RESIZE_DIM = 224  # JAX farneback.py:81 (reference train.py:302-318)
GRAY_WEIGHTS_BGR = (0.114, 0.587, 0.299)  # JAX farneback.py:378-379, cv2's Rec.601


def reference_flow_hw(staging_hw) -> tuple:
    """The resolution the reference computes Farnebäck at for frames staged
    at `staging_hw`: the larger side scaled down to FLOW_RESIZE_DIM, never
    up (JAX farneback.py:84-98)."""
    h, w = int(staging_hw[0]), int(staging_hw[1])
    m = max(h, w)
    if m <= FLOW_RESIZE_DIM:
        return (h, w)
    scale = FLOW_RESIZE_DIM / m
    return (int(round(h * scale)), int(round(w * scale)))


def flow_schedule_params(schedule: str):
    """'full' → None (the reference's schedule); 'turbo' → TURBO_PARAMS
    (JAX farneback.py:101-110)."""
    if schedule == "turbo":
        return dict(TURBO_PARAMS)
    if schedule == "full":
        return None
    raise ValueError(f"unknown flow schedule {schedule!r}")


@functools.lru_cache(maxsize=None)
def _poly_exp_setup(poly_n: int, poly_sigma: float):
    """The 1-D moment kernels (g, x·g, x²·g) and the inverse 6×6 normal
    matrix of the basis [1, x, y, x², y², xy] under the separable Gaussian
    weight (JAX farneback.py:113-136, numpy as there)."""
    r = (poly_n - 1) // 2
    xs = np.arange(-r, r + 1, dtype=np.float64)
    g = np.exp(-0.5 * (xs / poly_sigma) ** 2)
    g /= g.sum()
    xg = xs * g
    x2g = xs * xs * g

    W = np.outer(g, g)
    Y, X = np.meshgrid(xs, xs, indexing="ij")
    basis = np.stack([np.ones_like(X), X, Y, X * X, Y * Y, X * Y])
    G = np.einsum("inm,jnm,nm->ij", basis, basis, W)
    Ginv = np.linalg.inv(G)
    return (g.astype(np.float32), xg.astype(np.float32), x2g.astype(np.float32)), Ginv.astype(np.float32)


# Moment m (y kernel, x kernel) for the basis order of `r` below, JAX
# farneback.py:152-157: r = [r1, rx, ry, rxx, ryy, rxy].  0, 1, 2 are g, x·g, x²·g.
_MOMENTS = ((0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (1, 1))
# Rows of Ginv giving the planes, in the order (axx, ayy, axy, bx, by);
# axy's row is halved, as JAX halves its coefficient (exact: a power of 2).
_PLANE_ROWS, _PLANE_SCALE = (3, 4, 5, 1, 2), np.float32([1, 1, 0.5, 1, 1])


def _poly_exp_packed(img: torch.Tensor, kernels, Ginv: np.ndarray) -> torch.Tensor:
    """(N, H, W) → (N, 5, H, W) planes (axx, ayy, axy, bx, by) of the local
    quadratic fit.  Each moment is the y correlation of the image with its
    y kernel, then the x correlation with its x kernel, as JAX's depthwise
    pair computes it per channel; the y correlations are shared between
    the moments that use the same y kernel.  coef = r · Ginvᵀ is summed over
    the six moments in order, each product rounded on its own."""
    img = img.float()
    dev = img.device
    stack = np.stack(kernels)  # (3, k): g, x·g, x²·g
    y = _correlate(img.unsqueeze(1), _channel_taps(stack, dev), -2)  # (N, 3, H, W)
    y = y.index_select(1, _const(np.asarray([m[0] for m in _MOMENTS]), dev))
    r = _correlate(y, _channel_taps(stack[[m[1] for m in _MOMENTS]], dev), -1)  # (N, 6, H, W)
    rows = np.asarray(Ginv, np.float32)[list(_PLANE_ROWS)] * _PLANE_SCALE[:, None]  # (5, 6)
    coef = r[:, 0:1] * _const(rows[:, 0].reshape(1, 5, 1, 1), dev)
    for k in range(1, 6):
        coef += r[:, k : k + 1] * _const(rows[:, k].reshape(1, 5, 1, 1), dev)
    return coef


def _poly_exp_planes(img: torch.Tensor, kernels, Ginv: np.ndarray):
    """The quadratic fit as five (N, H, W) planes (axx, ayy, axy, bx, by),
    A = [[axx, axy], [axy, ayy]] (JAX farneback.py:139-165)."""
    return tuple(_poly_exp_packed(img, kernels, Ginv).unbind(1))


def polynomial_expansion(img: torch.Tensor, kernels, Ginv: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (A (N, H, W, 2, 2), b (N, H, W, 2)) (JAX farneback.py:168-183)."""
    axx, ayy, axy, bx, by = _poly_exp_planes(img, kernels, Ginv)
    A = torch.stack([torch.stack([axx, axy], -1), torch.stack([axy, ayy], -1)], -2)
    return A, torch.stack([bx, by], -1)


def _displacement_update_packed(p1: torch.Tensor, p2: torch.Tensor, flow: torch.Tensor, win: np.ndarray,
                                eps: float = 1e-6) -> torch.Tensor:
    """One displacement solve from packed planes (N, 5, H, W) of both frames
    and the current flow (N, H, W, 2) → the new flow (N, H, W, 2)."""
    axx, ayy, axy = ((p1[:, :3] + p2[:, :3]) * 0.5).unbind(1)
    u0, v0 = flow[..., 0], flow[..., 1]
    db1 = (p2[:, 3] - p1[:, 3]) * -0.5 + axx * u0 + axy * v0
    db2 = (p2[:, 4] - p1[:, 4]) * -0.5 + axy * u0 + ayy * v0
    stacked = torch.stack([axx * axx + axy * axy, axy * (axx + ayy), axy * axy + ayy * ayy,
                           axx * db1 + axy * db2, axy * db1 + ayy * db2], 1)
    taps = _float_taps(win)
    sm = _correlate(_correlate(stacked, taps, -2), taps, -1)
    G11, G12, G22, H1, H2 = sm.unbind(1)
    det = G11 * G22 - G12 * G12
    det = torch.where(torch.abs(det) < eps, eps, det)
    return torch.stack([(G22 * H1 - G12 * H2) / det, (G11 * H2 - G12 * H1) / det], -1)


def _displacement_update_planes(p1, p2, flow: torch.Tensor, win: np.ndarray, eps: float = 1e-6) -> torch.Tensor:
    """One Farnebäck displacement solve from both frames' plane tuples and
    the current flow: A = (A₁+A₂)/2, Δb = −½(b₂−b₁) + A·d₀, then
    (Σ_w AᵀA) d = Σ_w AᵀΔb per pixel over a winsize box, with det clamped
    to eps where |det| < eps (JAX farneback.py:186-225)."""
    return _displacement_update_packed(torch.stack(p1, 1), torch.stack(p2, 1), flow, win, eps)


def farneback_flow_pair(
    prev: torch.Tensor,
    curr: torch.Tensor,
    levels: int = 5,
    winsize: int = 11,
    iterations: int = 5,
    poly_n: int = 5,
    poly_sigma: float = 1.1,
    fast_warp: bool = False,
    max_disp: int = 32,
    fine_iterations: int | None = None,
    fine_max_disp: int | None = None,
    fine_levels: int = 1,
) -> torch.Tensor:
    """Dense flow prev → curr of gray images (N, H, W) (or one (H, W) pair)
    → (N, H, W, 2) float32 (JAX farneback.py:235-323).

    fast_warp picks the separable warp over the exact bilinear one; both
    clamp each warp's displacement to ±max_disp.  fine_iterations and
    fine_max_disp (TURBO_PARAMS) set a residual schedule at the
    `fine_levels` finest levels: one full-range warp by the incoming
    estimate, then warps of that warped frame by the residual only.  The
    coarsest level always runs the full schedule."""
    single = prev.dim() == 2
    if single:
        prev, curr = prev.unsqueeze(0), curr.unsqueeze(0)
    kernels, Ginv = _poly_exp_setup(poly_n, poly_sigma)
    win = box_kernel(winsize)

    def make_warp(disp: int):
        warp = warp_image_separable if fast_warp else warp_image_mxu
        return lambda img, f: warp(img, f, max_disp=disp)

    pyr_prev = build_pyramid(prev.float(), levels)
    pyr_curr = build_pyramid(curr.float(), levels)
    flow = prev.new_zeros(pyr_prev[-1].shape + (2,), dtype=torch.float32)
    n_fine = min(fine_levels, len(pyr_prev) - 1)
    for lvl in range(len(pyr_prev) - 1, -1, -1):
        p, c = pyr_prev[lvl], pyr_curr[lvl]
        if flow.shape[1:3] != p.shape[1:]:
            flow = upsample_flow(flow, p.shape[1:])
        p1 = _poly_exp_packed(p, kernels, Ginv)
        if lvl < n_fine and (fine_iterations or fine_max_disp):
            flow0 = flow
            cw0 = make_warp(max_disp)(c, flow0)
            small_warp = make_warp(fine_max_disp or max_disp)
            for i in range(fine_iterations or iterations):
                cw = cw0 if i == 0 else small_warp(cw0, flow - flow0)
                flow = _displacement_update_packed(p1, _poly_exp_packed(cw, kernels, Ginv), flow, win)
        else:
            warp = make_warp(max_disp)
            for _ in range(iterations):
                cw = warp(c, flow)
                flow = _displacement_update_packed(p1, _poly_exp_packed(cw, kernels, Ginv), flow, win)
        del p1
    return flow[0] if single else flow


def farneback_flow_clip(gray_clip: torch.Tensor, **params) -> torch.Tensor:
    """(T, H, W) gray frames → (T−1, H, W, 2) flow of consecutive pairs
    (JAX farneback.py:326-331)."""
    return farneback_flow_pair(gray_clip[:-1], gray_clip[1:], **params)


def farneback_flow_batch(
    prevs: torch.Tensor,
    currs: torch.Tensor,
    chunk_pairs: int | None = None,
    **params,
) -> torch.Tensor:
    """Flow for pairs with any leading dims: (..., H, W) → (..., H, W, 2)
    (JAX farneback.py:334-373).  The leading dims are flattened into one
    batch, solved `chunk_pairs` pairs at a time to bound the pyramid's
    intermediates (about 51 MB a 224² pair in JAX, farneback.py:350-353);
    each chunk's intermediates are freed before the next starts.  A pair's
    flow does not depend on the chunk it runs in."""
    h, w = prevs.shape[-2:]
    lead = prevs.shape[:-2]
    p = prevs.reshape(-1, h, w)
    c = currs.reshape(-1, h, w)
    n = p.shape[0]
    step = chunk_pairs if chunk_pairs and n > chunk_pairs else max(n, 1)
    flows: List[torch.Tensor] = [farneback_flow_pair(p[i : i + step], c[i : i + step], **params)
                                 for i in range(0, n, step)]
    out = flows[0] if len(flows) == 1 else torch.cat(flows)
    return out.reshape(lead + (h, w, 2))


def gray_pair_flow(
    gray: torch.Tensor,
    gray_next: torch.Tensor,
    out_hw,
    fast_warp: bool = False,
    flow_params: dict | None = None,
) -> torch.Tensor:
    """Farnebäck flow of staged gray pairs (B, T, H, W, 1) → (B, T, oh, ow, 2)
    float32 at the model size `out_hw`, as the member forward and the train
    steps compute it (JAX members.py:66-90, engine.py:75-113): the frames
    resized to the reference's flow resolution (`reference_flow_hw`) when
    staged larger, solved over the flat B·T pairs in chunks of
    FLOW_CHUNK_PAIRS with `flow_params` (None: the full schedule) and
    `fast_warp`, and the fields resized to out_hw, their values unchanged
    (displacement, not imagery: no input scale)."""
    kw = dict(flow_params or {})
    kw.setdefault("fast_warp", fast_warp)
    kw.setdefault("chunk_pairs", FLOW_CHUNK_PAIRS)
    gray, gray_next = gray.float(), gray_next.float()
    flow_hw = reference_flow_hw(gray.shape[2:4])
    if flow_hw != tuple(gray.shape[2:4]):
        gray, gray_next = crop_resize(gray, flow_hw), crop_resize(gray_next, flow_hw)
    flows = farneback_flow_batch(gray[..., 0], gray_next[..., 0], **kw)
    if flow_hw != tuple(out_hw):
        flows = crop_resize(flows, out_hw)
    return flows


def rgb_to_gray(clip: torch.Tensor) -> torch.Tensor:
    """BGR (the reference's decode order) → gray, float32, with cv2's Rec.601
    weights: 0.114·b + 0.587·g + 0.299·r (JAX farneback.py:376-379)."""
    b, g, r = clip[..., 0], clip[..., 1], clip[..., 2]
    wb, wg, wr = GRAY_WEIGHTS_BGR
    return b * wb + g * wg + r * wr

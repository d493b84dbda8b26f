"""TV-L1 dense optical flow on the card, over flat batches of pairs.

Counterpart of `crowded_scenes_ensemble_classification_tpu/flow/tvl1.py`:
Zach, Pock & Bischof 2007 in the IPOL (Sánchez et al. 2013) form, coarse to
fine; per warp, the first-order residual ρ(u) = I₁(x+u₀) + (u−u₀)·∇I₁ − I₀,
a three-case soft threshold on ρ, then a Chambolle dual step on p.  The
pyramids and warps are float32; the dual loop may run in bfloat16
(`compute_dtype`).  Every function takes a flat batch (N, H, W): the
joint min/max rescale to [0, 255] is per pair, a reduction over each row's
two frames, never across the batch.  No JAX path calls TV-L1; it is a
capability of the package, sharing the pyramid and warps with Farnebäck.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .pyramid import build_pyramid, image_gradients, upsample_flow, warp_image_mxu, warp_image_separable

# JAX tvl1.py:61-63: the adaptive schedule (2 warps of 8 dual steps at the
# three finest levels).
TVL1_TURBO_PARAMS = dict(fast_warp=True, fine_warps=2, fine_inner_iters=8, fine_levels=3)


def _forward_grad(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward differences of (..., H, W), last column / row zero (Neumann
    boundary; JAX tvl1.py:41-45)."""
    gx = torch.cat([x[..., 1:] - x[..., :-1], torch.zeros_like(x[..., :1])], -1)
    gy = torch.cat([x[..., 1:, :] - x[..., :-1, :], torch.zeros_like(x[..., :1, :])], -2)
    return gx, gy


def _divergence(px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Backward-difference divergence, the adjoint of `_forward_grad`
    (JAX tvl1.py:48-52)."""
    dx = torch.cat([px[..., :1], px[..., 1:-1] - px[..., :-2], -px[..., -2:-1]], -1)
    dy = torch.cat([py[..., :1, :], py[..., 1:-1, :] - py[..., :-2, :], -py[..., -2:-1, :]], -2)
    return dx + dy


def tvl1_flow_pair(
    prev: torch.Tensor,
    curr: torch.Tensor,
    levels: int = 5,
    warps: int = 5,
    inner_iters: int = 30,
    tau: float = 0.25,
    lambda_: float = 0.15,
    theta: float = 0.3,
    eps_grad: float = 1e-6,
    fast_warp: bool = False,
    compute_dtype: torch.dtype = torch.float32,
    max_disp: int = 32,
    fine_warps: int | None = None,
    fine_inner_iters: int | None = None,
    fine_levels: int = 0,
) -> torch.Tensor:
    """Dense TV-L1 flow prev → curr of gray images (N, H, W) (or one (H, W)
    pair) → (N, H, W, 2) float32 (JAX tvl1.py:73-193).

    Each pair is rescaled jointly to [0, 255], where λ = 0.15 is
    calibrated.  compute_dtype=torch.bfloat16 runs the dual loop in bf16;
    its constants are rounded to bf16 first, as JAX rounds a Python scalar
    to the array's type.  fine_warps / fine_inner_iters cut the schedule at
    the `fine_levels` finest levels (TVL1_TURBO_PARAMS)."""
    single = prev.dim() == 2
    if single:
        prev, curr = prev.unsqueeze(0), curr.unsqueeze(0)
    prev, curr = prev.float(), curr.float()
    lo = torch.minimum(prev.amin((-2, -1)), curr.amin((-2, -1)))[:, None, None]
    hi = torch.maximum(prev.amax((-2, -1)), curr.amax((-2, -1)))[:, None, None]
    scale = 255.0 / torch.clamp_min(hi - lo, 1e-6)
    prev = (prev - lo) * scale
    curr = (curr - lo) * scale

    I0_pyr = build_pyramid(prev, levels)
    I1_pyr = build_pyramid(curr, levels)

    def const(v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=compute_dtype)

    lt = lambda_ * theta
    taut = tau / theta
    lt_c, neg_lt_c, theta_c, taut_c = const(lt), const(-lt), const(theta), const(taut)
    eps_c, one_c = const(eps_grad), const(1.0)
    flow = prev.new_zeros(I0_pyr[-1].shape + (2,))

    for lvl in range(len(I0_pyr) - 1, -1, -1):
        I0, I1 = I0_pyr[lvl], I1_pyr[lvl]
        if flow.shape[1:3] != I0.shape[1:]:
            flow = upsample_flow(flow, I0.shape[1:])
        I1x_full, I1y_full = image_gradients(I1)
        fine = lvl < fine_levels
        warps_lvl = fine_warps if (fine and fine_warps) else warps
        inner_lvl = fine_inner_iters if (fine and fine_inner_iters) else inner_iters
        warp = warp_image_separable if fast_warp else warp_image_mxu
        for _ in range(warps_lvl):
            u0 = flow
            # the image and both gradients resampled at the same positions
            I1w, I1wx, I1wy = warp(torch.stack([I1, I1x_full, I1y_full], 1), u0, max_disp=max_disp).unbind(1)
            grad2 = I1wx**2 + I1wy**2
            rho_c = I1w - I1wx * u0[..., 0] - I1wy * u0[..., 1] - I0
            I1wx, I1wy = I1wx.to(compute_dtype), I1wy.to(compute_dtype)
            grad2, rho_c = grad2.to(compute_dtype), rho_c.to(compute_dtype)
            u = u0.to(compute_dtype)
            px1 = py1 = px2 = py2 = torch.zeros(I0.shape, dtype=compute_dtype, device=I0.device)
            for _ in range(inner_lvl):
                rho = rho_c + I1wx * u[..., 0] + I1wy * u[..., 1]
                case1 = rho < -lt_c * grad2
                case2 = rho > lt_c * grad2
                denom = torch.maximum(grad2, eps_c)
                d1 = torch.where(case1, lt_c * I1wx, torch.where(case2, neg_lt_c * I1wx, -rho * I1wx / denom))
                d2 = torch.where(case1, lt_c * I1wy, torch.where(case2, neg_lt_c * I1wy, -rho * I1wy / denom))
                v1 = u[..., 0] + d1
                v2 = u[..., 1] + d2
                # u = v + θ·div(p); then Chambolle dual ascent on p
                u1 = v1 + theta_c * _divergence(px1, py1)
                u2 = v2 + theta_c * _divergence(px2, py2)
                g1x, g1y = _forward_grad(u1)
                g2x, g2y = _forward_grad(u2)
                n1 = torch.sqrt(g1x**2 + g1y**2)
                n2 = torch.sqrt(g2x**2 + g2y**2)
                px1 = (px1 + taut_c * g1x) / (one_c + taut_c * n1)
                py1 = (py1 + taut_c * g1y) / (one_c + taut_c * n1)
                px2 = (px2 + taut_c * g2x) / (one_c + taut_c * n2)
                py2 = (py2 + taut_c * g2y) / (one_c + taut_c * n2)
                u = torch.stack([u1, u2], -1)
            bound = float(max(I0.shape[1:]))
            flow = u.float().clamp(-bound, bound)  # median-free stabilisation
    return flow[0] if single else flow


def tvl1_flow_clip(gray_clip: torch.Tensor, **params) -> torch.Tensor:
    """(T, H, W) → (T−1, H, W, 2) for consecutive pairs (JAX tvl1.py:196-200)."""
    return tvl1_flow_pair(gray_clip[:-1], gray_clip[1:], **params)


def quantize_flow_u8(flow: torch.Tensor, bound: float = 20.0) -> torch.Tensor:
    """py-denseflow's uint8 storage: clip to ±bound, map to 0..255, round
    half to even (JAX tvl1.py:203-208; reference train.py:335-358)."""
    q = torch.clamp(flow, -bound, bound)
    return torch.round((q + bound) * (255.0 / (2.0 * bound))).to(torch.uint8)


def dequantize_flow_u8(q: torch.Tensor, bound: float = 20.0) -> torch.Tensor:
    """JAX tvl1.py:211-212."""
    return q.to(torch.float32) * (2.0 * bound / 255.0) - bound

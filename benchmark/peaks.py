"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit), and the bound
arithmetic of a roofline share."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {
    "bfloat16": 989e12,
    "float16": 989e12,
    "int8": 1979e12,
    "fp8": 1979e12,
    "tf32": 495e12,
    "float32": 67e12,
}


def bound_s(flops: float, nbytes: float, precision: str) -> float:
    """The least time the card could take: the larger of operations over
    the peak rate of `precision` and bytes over the HBM bandwidth."""
    return max(flops / FLOPS_PER_S[precision], nbytes / HBM_BYTES_PER_S)


def share_pct(bound: float, measured: float):
    """A roofline share in %, or None when nothing was measured."""
    return None if measured <= 0.0 else 100.0 * bound / measured

"""Score fusion of member probabilities.

Counterpart of `crowded_scenes_ensemble_classification_tpu/ensemble/fusion.py`
(`fuse_predictions`, lines 29-62, and the SUM weights): weighted sum of
the (M, N, C) softmax matrices then argmax, or the MAXIMUM sentinel, argmax
over the flattened M·C scores mod C.  Grid search and differential
evolution are not ported yet.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

MAXIMUM = "MAXIMUM"


def sum_weights(n_members: int) -> np.ndarray:
    return np.ones(n_members)


def fuse_predictions(yhats: torch.Tensor, weights: Union[str, np.ndarray, torch.Tensor]) -> torch.Tensor:
    """(M, N, C) member probabilities → (N,) int64 class predictions on
    the same device."""
    yhats = yhats.to(torch.float32)
    if isinstance(weights, str):
        if weights != MAXIMUM:
            raise ValueError(f"unknown weights sentinel {weights!r}")
        m, n, c = yhats.shape
        flat = yhats.permute(1, 0, 2).reshape(n, m * c)
        return torch.remainder(torch.argmax(flat, dim=-1), c)
    w = torch.as_tensor(weights, dtype=torch.float32, device=yhats.device)
    return torch.argmax(torch.einsum("mnc,m->nc", yhats, w), dim=-1)

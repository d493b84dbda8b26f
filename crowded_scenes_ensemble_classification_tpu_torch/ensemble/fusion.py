"""Score fusion of member probabilities and the five weighting schemes.

Counterpart of `crowded_scenes_ensemble_classification_tpu/ensemble/fusion.py`
(lines 29-182; reference evaluate_ensemble.py):

- fusion: weighted sum of the (M, N, C) softmax matrices then argmax, or
  the MAXIMUM sentinel, argmax over the flattened M·C scores mod C (:343-370);
- L1 normalize with all-zero passthrough (:282-289);
- SUM = ones (:1249-1250); VALIDATION_ERROR_INVERSE = normalized 1/min
  val-loss per member (:33-62); GRID_SEARCH = cartesian {0,0.1,…,1}^M,
  skip all-equal, L1-normalized, first best wins (:322-339);
  DIFFERENTIAL_EVOLUTION = scipy DE, bounds [0,1], maxiter 20, tol 1e-7,
  loss = 1 − ensemble accuracy (:293-311).

Fusion runs on the device of the probability tensor.  Weighted sums are
taken member by member in a fixed order, a multiply and an add per member,
each rounded to float32 on its own: the same values on the card and on the
CPU, so an evaluation gives the same predictions and weights on both (a
matmul's order and fused multiply-adds differ between the two).
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence, Union

import numpy as np
import torch

MAXIMUM = "MAXIMUM"
GRID_VALUES = np.round(np.arange(0.0, 1.01, 0.1), 1)
GRID_CHUNK_ELEMENTS = 1 << 26  # float32 elements of one chunk of candidate sums (256 MB)


def normalize_l1(weights) -> np.ndarray:
    w = np.asarray(weights, np.float64)
    n = np.linalg.norm(w, 1)
    if n == 0.0:
        return w
    return w / n


def _weighted_sum(yhats: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Σ_m weights[..., m] · yhats[m] in member order: yhats (M, ...) and
    weights (M,) → (...), or weights (K, M) with yhats (M, L) → (K, L)."""
    column = (lambda m: weights[m]) if weights.dim() == 1 else (lambda m: weights[:, m : m + 1])
    total = column(0) * yhats[0]
    for m in range(1, yhats.shape[0]):
        total = total + column(m) * yhats[m]
    return total


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
    return torch.argmax(_weighted_sum(yhats, w), dim=-1)


def _tensor(yhats) -> torch.Tensor:
    """Probabilities as a float32 tensor, on its own device if it is one
    (numpy arrays go to the CPU)."""
    return torch.as_tensor(yhats).to(torch.float32)


def ensemble_accuracy(yhats, weights, labels) -> float:
    preds = fuse_predictions(_tensor(yhats), weights)
    return float(np.mean(preds.cpu().numpy() == np.asarray(labels)))


def single_model_predictions(yhat: np.ndarray) -> np.ndarray:
    """(N, C) → argmax predictions (reference evaluate_single_model,
    evaluate_ensemble.py:86-100)."""
    return np.argmax(np.asarray(yhat), axis=1)


# ------------------------------------------------------------------
# Weighting schemes
# ------------------------------------------------------------------


def sum_weights(n_members: int) -> np.ndarray:
    return np.ones(n_members)


def validation_error_inverse_weights(min_val_losses: Sequence[float]) -> np.ndarray:
    """w_i = (1/min_val_loss_i) / Σ(1/min_val_loss_j)
    (evaluate_ensemble.py:33-62)."""
    inv = 1.0 / np.asarray(min_val_losses, np.float64)
    return inv / inv.sum()


def _grid_candidates(n_members: int) -> np.ndarray:
    """All {0,0.1,…,1}^M rows in itertools.product order, all-equal rows
    removed, L1-normalized: the reference's iteration and skip rule
    (evaluate_ensemble.py:322-339)."""
    rows = []
    for combo in itertools.product(GRID_VALUES, repeat=n_members):
        if len(set(combo)) == 1:
            continue
        rows.append(normalize_l1(combo))
    return np.asarray(rows, np.float32)


def grid_search_weights(yhats, labels) -> np.ndarray:
    """Exhaustive grid search on the probabilities' device: the
    (K, M)·(M, N·C) candidate sums (in chunks of K), each candidate's
    argmax predictions and count of correct ones.  The first best candidate
    wins, the reference's sequential `score > best_score` over
    itertools.product order (argmax returns the first maximum)."""
    yhats = _tensor(yhats)
    m, n, c = yhats.shape
    flat = yhats.reshape(m, n * c)
    labels = torch.as_tensor(labels).to(yhats.device)
    cands = _grid_candidates(m)
    weights = torch.from_numpy(cands).to(yhats.device)
    chunk = max(1, GRID_CHUNK_ELEMENTS // (n * c))
    correct = torch.cat([
        (_weighted_sum(flat, weights[k : k + chunk]).reshape(-1, n, c).argmax(-1) == labels).sum(-1)
        for k in range(0, len(cands), chunk)
    ])
    best = int(torch.argmax(correct))
    return cands[best].astype(np.float64)


def differential_evolution_weights(
    yhats,
    labels,
    maxiter: int = 20,
    tol: float = 1e-7,
    seed: Optional[int] = None,
) -> np.ndarray:
    """scipy DE over the ensemble accuracy on the probabilities' device
    (evaluate_ensemble.py:293-311).  The accuracy is the float32 fraction
    correct, as the JAX package scores it.  The reference left DE unseeded
    (non-reproducible); pass `seed` for deterministic runs."""
    from scipy.optimize import differential_evolution

    yhats = _tensor(yhats)
    labels = torch.as_tensor(labels).to(yhats.device)
    n = np.float32(labels.numel())

    def loss(w):
        correct = int((fuse_predictions(yhats, normalize_l1(w)) == labels).sum())
        return 1.0 - float(np.float32(correct) / n)

    result = differential_evolution(
        loss, [(0.0, 1.0)] * int(yhats.shape[0]), maxiter=maxiter, tol=tol, seed=seed, disp=False
    )
    return normalize_l1(result["x"])


def compute_weights(
    scheme: str,
    n_members: int,
    *,
    yhats_trainval=None,
    labels_trainval=None,
    min_val_losses=None,
    de_seed: Optional[int] = None,
) -> Union[str, np.ndarray]:
    """Dispatch table of evaluate_ensemble.py:1206-1256.  GRID_SEARCH and
    DIFFERENTIAL_EVOLUTION score candidates on train+val probabilities
    (the reference's selection set), on their device."""
    if scheme == "SUM":
        return sum_weights(n_members)
    if scheme == "MAXIMUM":
        return MAXIMUM
    if scheme == "VALIDATION_ERROR_INVERSE":
        if min_val_losses is None:
            raise ValueError("VALIDATION_ERROR_INVERSE needs min_val_losses")
        return validation_error_inverse_weights(min_val_losses)
    if scheme == "GRID_SEARCH":
        return grid_search_weights(yhats_trainval, labels_trainval)
    if scheme == "DIFFERENTIAL_EVOLUTION":
        return differential_evolution_weights(yhats_trainval, labels_trainval, seed=de_seed)
    raise ValueError(f"unknown weighting scheme {scheme!r}")

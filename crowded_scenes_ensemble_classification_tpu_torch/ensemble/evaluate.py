"""Ensemble evaluators: homogeneous, global heterogeneous, combination search.

Counterpart of `crowded_scenes_ensemble_classification_tpu/ensemble/evaluate.py`
(lines 44-200), reproducing the reference:

- homogeneous (`evaluate_ensembles`, evaluate_ensemble.py:1112-1273): per
  test fold t, the k−1 per-val-fold members are fused with the chosen
  weighting scheme; GRID_SEARCH / DIFFERENTIAL_EVOLUTION select weights on
  the train+val probability tensor (:1206-1248); per-member accuracies are
  recorded alongside; predictions go to
  `weighted_prediction_results_{name}.csv` (:1266-1268) and learned weights
  to `.npy` (:1270-1272);
- global heterogeneous (`global_evaluate_ensembles`, :1329-1474): the
  member tensors of every configuration concatenated and fused with equal
  weights (:1455), mean accuracy over folds (:1474);
- combination search (`combine_ensembles` :1298-1326, `compute_combinations`
  :1280-1295): every non-empty subset of the configurations,
  global-evaluated, sorted by mean accuracy.

Data flows through probability tensors (`probability_store`), not model
re-execution.  Fusion and the weight searches run on `device`: the card
unless the caller names another.  The CSVs are written with the `csv`
module and equal the JAX package's pandas output byte for byte.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..utils.device import resolve_device
from .fusion import compute_weights, fuse_predictions, single_model_predictions
from .probability_store import write_csv

# (test_index, subset) -> {"probs": (M, N, C), "labels": (N,)}
ProbProvider = Callable[[int, str], Dict[str, np.ndarray]]


@dataclasses.dataclass
class FoldResult:
    test_index: int
    accuracy: float
    predictions: np.ndarray
    weights: Union[str, np.ndarray]
    member_accuracies: List[float]


@dataclasses.dataclass
class EnsembleResults:
    name: str
    scheme: str
    folds: List[FoldResult]

    @property
    def mean_accuracy(self) -> float:
        return float(np.mean([f.accuracy for f in self.folds]))

    def prediction_rows(self) -> List[Tuple[str, str]]:
        """(path, predictions) rows of the reference's results CSV."""
        return [
            (f"Ensemble_{self.name}_split_test{f.test_index}", repr(np.asarray(f.predictions).tolist()))
            for f in self.folds
        ]

    def save_predictions_csv(self, results_folder: str) -> str:
        path = os.path.join(results_folder, f"weighted_prediction_results_{self.name}.csv")
        return write_csv(path, ("path", "predictions"), self.prediction_rows())

    def save_weights_npy(self, results_folder: str) -> Optional[str]:
        if self.scheme not in ("GRID_SEARCH", "DIFFERENTIAL_EVOLUTION"):
            return None
        os.makedirs(results_folder, exist_ok=True)
        path = os.path.join(results_folder, f"{self.scheme}_{self.name}.npy")
        np.save(path, np.stack([np.asarray(f.weights) for f in self.folds]))
        return path


def _fold_result(t: int, probs: np.ndarray, labels: np.ndarray, weights, device: torch.device,
                 member_accuracies: bool) -> FoldResult:
    preds = fuse_predictions(torch.as_tensor(probs).to(device), weights).cpu().numpy()
    accs = [float(np.mean(single_model_predictions(p) == labels)) for p in probs] if member_accuracies else []
    return FoldResult(t, float(np.mean(preds == labels)), preds, weights, accs)


def evaluate_ensembles(
    prob_provider: ProbProvider,
    folds_number: int,
    scheme: str,
    name: str = "ensemble",
    min_val_losses_provider: Optional[Callable[[int], Sequence[float]]] = None,
    de_seed: Optional[int] = None,
    precomputed_weights: Optional[np.ndarray] = None,
    device=None,
) -> EnsembleResults:
    """Homogeneous k-fold ensemble evaluation."""
    device = resolve_device(device)
    folds: List[FoldResult] = []
    for t in range(folds_number):
        test = prob_provider(t, "test")
        probs, labels = test["probs"], test["labels"]
        m = probs.shape[0]
        if precomputed_weights is not None:
            weights = precomputed_weights[t]
        elif scheme in ("GRID_SEARCH", "DIFFERENTIAL_EVOLUTION"):
            trainval = prob_provider(t, "train_val")
            weights = compute_weights(
                scheme,
                m,
                yhats_trainval=torch.as_tensor(trainval["probs"]).to(device),
                labels_trainval=trainval["labels"],
                de_seed=de_seed,
            )
        elif scheme == "VALIDATION_ERROR_INVERSE":
            weights = compute_weights(scheme, m, min_val_losses=min_val_losses_provider(t))
        else:
            weights = compute_weights(scheme, m)
        folds.append(_fold_result(t, probs, labels, weights, device, member_accuracies=True))
    return EnsembleResults(name=name, scheme=scheme, folds=folds)


# ------------------------------------------------------------------
# Global (heterogeneous) ensembles
# ------------------------------------------------------------------


def global_evaluate_ensembles(
    prob_providers: Dict[str, ProbProvider],
    folds_number: int,
    name: str = "global",
    device=None,
) -> EnsembleResults:
    """Equal-weight fusion of all members of every configuration
    (evaluate_ensemble.py:1329-1474)."""
    device = resolve_device(device)
    folds: List[FoldResult] = []
    for t in range(folds_number):
        tensors, labels = [], None
        for cfg_name, provider in prob_providers.items():
            d = provider(t, "test")
            tensors.append(d["probs"])
            if labels is None:
                labels = d["labels"]
            elif not np.array_equal(labels, d["labels"]):
                raise ValueError(f"label mismatch between configs on test fold {t} (config {cfg_name})")
        probs = np.concatenate(tensors, axis=0)
        folds.append(_fold_result(t, probs, labels, np.ones(probs.shape[0]), device, member_accuracies=False))
    return EnsembleResults(name=name, scheme="SUM", folds=folds)


def save_global_predictions_csv(results: EnsembleResults, results_folder: str) -> str:
    """`global_ensemble_summed_prediction_results_{name}.csv`
    (evaluate_ensemble.py:1468-1471)."""
    path = os.path.join(results_folder, f"global_ensemble_summed_prediction_results_{results.name}.csv")
    return write_csv(path, ("path", "predictions"), results.prediction_rows())


def compute_combinations(items: Sequence[str]) -> List[Tuple[str, ...]]:
    """All non-empty subsets, shortest first (evaluate_ensemble.py:1280-1295)."""
    out: List[Tuple[str, ...]] = []
    for r in range(1, len(items) + 1):
        out.extend(itertools.combinations(items, r))
    return out


def combine_ensembles(
    prob_providers: Dict[str, ProbProvider],
    folds_number: int,
    device=None,
) -> List[Tuple[Tuple[str, ...], float]]:
    """Global-evaluate every subset; [(subset, mean accuracy)] sorted by
    accuracy, highest first, ties in subset order (evaluate_ensemble.py:1298-1326)."""
    device = resolve_device(device)
    results = []
    for subset in compute_combinations(list(prob_providers.keys())):
        sub = {k: prob_providers[k] for k in subset}
        res = global_evaluate_ensembles(sub, folds_number, name="+".join(subset), device=device)
        results.append((subset, res.mean_accuracy))
    results.sort(key=lambda x: x[1], reverse=True)
    return results

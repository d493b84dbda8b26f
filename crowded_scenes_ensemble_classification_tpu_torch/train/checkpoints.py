"""Checkpoint I/O on `torch.save`.

Counterpart of `crowded_scenes_ensemble_classification_tpu/train/checkpoints.py`,
with two artifacts of the port's own format (the JAX package's orbax and
flax msgpack checkpoints are not read):

- `best.pt`: the best-val-loss model state dict only (the reference's
  `{name}_weights.hdf5`, train.py:1850-1853), for eval and ensembles;
- `full.pt`: the whole `TrainState` (module, optimizer state, step, seed)
  for exact resume, which the reference could not do.

Each file is written beside its target and renamed over it, so a reader
never sees half a file.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
import torch.nn as nn

from .state import TrainState


def _path(checkpoint_dir: str, name: str) -> str:
    return os.path.join(os.path.abspath(checkpoint_dir), name)


def _save(path: str, obj) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)
    return path


def _load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def save_best(checkpoint_dir: str, variables: Dict[str, torch.Tensor]) -> str:
    """Write a model state dict as the best checkpoint; returns its path."""
    return _save(_path(checkpoint_dir, "best.pt"), variables)


def best_exists(checkpoint_dir: str) -> bool:
    return os.path.exists(_path(checkpoint_dir, "best.pt"))


def restore_best(checkpoint_dir: str, target: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """The best checkpoint's state dict (on the CPU), loaded strictly into
    `target` when one is given."""
    variables = _load(_path(checkpoint_dir, "best.pt"))
    if target is not None:
        target.load_state_dict(variables)
    return variables


def save_full(checkpoint_dir: str, state: TrainState) -> str:
    """Write the whole train state for exact resume; returns its path."""
    return _save(_path(checkpoint_dir, "full.pt"), {
        "module": state.module.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": state.step,
        "seed": state.seed,
    })


def full_exists(checkpoint_dir: str) -> bool:
    return os.path.exists(_path(checkpoint_dir, "full.pt"))


def restore_full(checkpoint_dir: str, target: TrainState) -> TrainState:
    """Load the full checkpoint into `target` (module, optimizer, step,
    seed) and return it."""
    saved = _load(_path(checkpoint_dir, "full.pt"))
    target.module.load_state_dict(saved["module"])
    target.optimizer.load_state_dict(saved["optimizer"])
    target.step, target.seed = int(saved["step"]), int(saved["seed"])
    return target

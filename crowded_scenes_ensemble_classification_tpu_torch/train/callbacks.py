"""Epoch-level training control: LR schedules, plateau reduction, early
stopping, NaN guard.

Counterpart of `crowded_scenes_ensemble_classification_tpu/train/callbacks.py`,
restated: the same state machines and numbers.  They mirror the
reference's Keras callback stack (train.py:1850-1871):

- C3D: LearningRateScheduler dividing the *current* lr by 10 every 4 epochs
  (scheduler train.py:1774-1783) + ReduceLROnPlateau(0.5, patience 200,
  min_delta 1e-4, cooldown 2, min_lr 1e-6)
- I3D / TwoStream: ReduceLROnPlateau(0.1, patience 0, min_lr 1e-6)
- R3D: the reference's dedicated 'R3D' branch is dead code (its model names
  are 'R3D_18' etc., train.py:1862), so R3D actually trains with the I3D
  plateau policy — reproduced here on purpose (SURVEY.md §7.3.4c)
- EarlyStopping(val_loss, patience 100) everywhere (train.py:1854)
- TerminateOnNaN: imported but never wired in the reference (train.py:16);
  here it IS wired (SURVEY.md §5 failure-detection plan).

All callbacks are plain host-side state machines, run between epochs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass
class StepDecayEvery4:
    """lr ← lr/10 at every epoch divisible by 4 (compounding)."""

    def __call__(self, epoch: int, lr: float) -> float:
        if epoch % 4 == 0 and epoch != 0:
            return lr / 10.0
        return lr


@dataclasses.dataclass
class ReduceLROnPlateau:
    factor: float
    patience: int
    min_delta: float = 0.0
    cooldown: int = 0
    min_lr: float = 0.0

    best: float = math.inf
    wait: int = 0
    cooldown_counter: int = 0

    def update(self, val_loss: float, lr: float) -> float:
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        if val_loss < self.best - self.min_delta:
            self.best = val_loss
            self.wait = 0
            return lr
        if self.cooldown_counter > 0:
            return lr
        self.wait += 1
        # Keras triggers on wait >= patience (the patience-th bad epoch)
        if self.wait >= self.patience:
            new_lr = max(lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.wait = 0
            return new_lr
        return lr


@dataclasses.dataclass
class EarlyStopping:
    patience: int
    min_delta: float = 0.0

    best: float = math.inf
    wait: int = 0

    def update(self, val_loss: float) -> bool:
        """Returns True when training should stop."""
        if val_loss < self.best - self.min_delta:
            self.best = val_loss
            self.wait = 0
            return False
        self.wait += 1
        # Keras stops on wait >= patience
        return self.wait >= self.patience


@dataclasses.dataclass
class LRPolicy:
    """Per-architecture bundle (initial lr + schedules)."""

    initial_lr: float
    step_decay: Optional[StepDecayEvery4] = None
    plateau: Optional[ReduceLROnPlateau] = None

    def epoch_begin_lr(self, epoch: int, lr: float) -> float:
        if self.step_decay is not None:
            return self.step_decay(epoch, lr)
        return lr

    def epoch_end_lr(self, val_loss: float, lr: float) -> float:
        if self.plateau is not None:
            return self.plateau.update(val_loss, lr)
        return lr


def lr_policy_for(model_type: str) -> LRPolicy:
    """Reference optimizer/LR table (train.py:1856-1885)."""
    if model_type == "C3D":
        return LRPolicy(
            initial_lr=0.003,
            step_decay=StepDecayEvery4(),
            plateau=ReduceLROnPlateau(
                factor=0.5, patience=200, min_delta=1e-4, cooldown=2, min_lr=1e-6
            ),
        )
    # I3D, TWOSTREAM_I3D — and R3D via the dead-branch fallthrough
    return LRPolicy(
        initial_lr=0.003 if "I3D" in model_type else 1e-3,
        plateau=ReduceLROnPlateau(factor=0.1, patience=0, min_lr=1e-6),
    )

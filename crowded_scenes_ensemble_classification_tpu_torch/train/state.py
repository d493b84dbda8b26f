"""Train state and the Keras optimizers.

Counterpart of `crowded_scenes_ensemble_classification_tpu/train/state.py`.
There an optax transformation is a pure function and its state travels in
the `TrainState`; here an optimizer is a `torch.optim.Optimizer` bound to
the module's parameters.  So `keras_sgd`, `keras_adam` and `make_optimizer`
return a factory (`tx(params) → optimizer`), which `TrainState.create`
binds; the train steps take the same `tx` and check that the state was
made from it.

Both optimizers are Keras 2.2.4's own formulations, which `torch.optim.SGD`
and `torch.optim.Adam` are not (PARITY.md:18): torch's SGD keeps
`buf ← μ·buf + g` and steps by `lr·buf`, which rescales the whole velocity
when the learning rate drops, and torch's Adam puts eps on the
bias-corrected v̂.  A parameter with no gradient (`grad is None`) steps as
with a zero gradient, as optax treats every leaf.  Frozen parameters
(`requires_grad=False`, the BatchNorm weight that stands for the
reference's absent scale) are not given to the optimizer at all.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Iterable, List

import numpy as np
import torch
import torch.nn as nn

OptimizerFactory = Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]


def _grads(params: List[torch.Tensor]) -> List[torch.Tensor]:
    return [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]


class KerasSGD(torch.optim.Optimizer):
    """Keras 2.2.4 SGD in its velocity form (keras/optimizers.py
    SGD.get_updates; JAX train/state.py:51-77):

        v ← momentum·v − lr·g ;  p ← p + v

    After a learning-rate drop the velocity keeps its old scale and only
    new gradients take the new rate."""

    def __init__(self, params, lr: float, momentum: float = 0.0):
        super().__init__(params, dict(lr=lr, momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = group["params"]
            for p in params:
                if "velocity" not in self.state[p]:
                    self.state[p]["velocity"] = torch.zeros_like(p)
            velocity = [self.state[p]["velocity"] for p in params]
            torch._foreach_mul_(velocity, group["momentum"])
            torch._foreach_add_(velocity, _grads(params), alpha=-group["lr"])
            torch._foreach_add_(params, velocity)
        return loss


class KerasAdam(torch.optim.Optimizer):
    """Keras 2.2.4 Adam (keras/optimizers.py Adam; JAX train/state.py:86-125):

        lr_t = lr·sqrt(1−b2^t)/(1−b1^t)
        m ← b1·m + (1−b1)·g ;  v ← b2·v + (1−b2)·g²
        p ← p − lr_t·m/(sqrt(v) + eps)

    eps sits outside the sqrt, on the uncorrected v: Keras's effective eps
    is eps/sqrt(1−b2^t), about 32× torch's at step 1 with eps = 1e-7.
    lr_t is computed in float32, as Keras computes it on a float32 model
    and the JAX optimizer does (train/state.py:108-110): 1 − b2^t cancels,
    so the float32 step size differs from the exact one by up to 1.3e-5
    relative in the first steps."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = group["params"]
            b1, b2 = group["b1"], group["b2"]
            for p in params:
                if "step" not in self.state[p]:
                    self.state[p].update(step=0, m=torch.zeros_like(p), v=torch.zeros_like(p))
                self.state[p]["step"] += 1
            if not params:
                continue
            t = np.float32(self.state[params[0]]["step"])
            f32 = np.float32
            lr_t = float(f32(group["lr"]) * np.sqrt(f32(1.0) - f32(b2) ** t) / (f32(1.0) - f32(b1) ** t))
            grads = _grads(params)
            m = [self.state[p]["m"] for p in params]
            v = [self.state[p]["v"] for p in params]
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, grads, alpha=1.0 - b1)
            torch._foreach_mul_(v, b2)
            torch._foreach_addcmul_(v, grads, grads, value=1.0 - b2)
            denom = torch._foreach_sqrt(v)
            torch._foreach_add_(denom, group["eps"])
            torch._foreach_addcdiv_(params, m, denom, value=-lr_t)
        return loss


def keras_sgd(learning_rate: float, momentum: float = 0.0) -> OptimizerFactory:
    """Factory of `KerasSGD(params, learning_rate, momentum)`."""
    return functools.partial(KerasSGD, lr=learning_rate, momentum=momentum)


def keras_adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-7) -> OptimizerFactory:
    """Factory of `KerasAdam(params, learning_rate, b1, b2, eps)`; eps is
    Keras's K.epsilon() = 1e-7 (the reference's Adam(lr=1e-3) for R3D,
    train.py:1880-1881)."""
    return functools.partial(KerasAdam, lr=learning_rate, b1=b1, b2=b2, eps=eps)


def make_optimizer(model_type: str, initial_lr: float) -> OptimizerFactory:
    """The reference's optimizer table (train.py:1874-1885; JAX
    train/state.py:128-147): SGD with momentum 0.9 for I3D and TwoStream,
    plain SGD for C3D, Adam (Keras eps 1e-7) for R3D.  The epoch callbacks
    change the learning rate with `set_learning_rate`."""
    if model_type in ("I3D", "TWOSTREAM_I3D"):
        return keras_sgd(initial_lr, momentum=0.9)
    if model_type == "C3D":
        return keras_sgd(initial_lr)
    if model_type.startswith("R3D"):
        return keras_adam(initial_lr, eps=1e-7)
    raise ValueError(f"unknown model_type {model_type}")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    """Set the learning rate of every parameter group."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
    return optimizer


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


@dataclasses.dataclass
class TrainState:
    """The module (weights and BatchNorm statistics), its optimizer (with
    the velocities or moments), the factory `tx` that made the optimizer,
    the step count and the seed of the augment decisions.  The train steps
    update it in place and return it."""

    step: int
    module: nn.Module
    optimizer: torch.optim.Optimizer
    tx: OptimizerFactory
    seed: int

    @classmethod
    def create(cls, module: nn.Module, tx: OptimizerFactory, seed: int = 0) -> "TrainState":
        """Step 0, an optimizer from `tx` over the module's trainable
        parameters."""
        return cls(0, module, tx([p for p in module.parameters() if p.requires_grad]), tx, seed)

    def variables(self) -> Dict[str, torch.Tensor]:
        """The module's state dict: weights and running statistics."""
        return self.module.state_dict()

"""Transform composition (vidaug/augmentors/group.py equivalents).

Counterpart of `crowded_scenes_ensemble_classification_tpu/ops/group.py`
(lines 1-114).  A transform is a function ``(clip, generator) -> clip``;
the combinators draw their choices from the same `torch.Generator`, in
Python (JAX traces every branch under `lax.switch`/`lax.cond`; eager
PyTorch runs only the chosen one, so shape-changing members are allowed):

- `sequential`: every transform in order, or in the order of a random
  permutation (`torch.randperm`);
- `one_of`: one transform, its index `torch.randint(n)`;
- `some_of`: the first n of a random permutation, applied in that order
  (`random_order`) or in list order;
- `sometimes`: the transform when `torch.rand() < p`.

Each choice is drawn before the chosen transforms draw theirs.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

Transform = Callable[[torch.Tensor, torch.Generator], torch.Tensor]


def _apply(transforms: Sequence[Transform], order, clip: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    for i in order:
        clip = transforms[int(i)](clip, generator)
    return clip


def sequential(transforms: Sequence[Transform], random_order: bool = False) -> Transform:
    """Apply every transform in order, or in a random order (vidaug group.py:25-49)."""
    transforms = list(transforms)

    def apply(clip, generator):
        n = len(transforms)
        order = torch.randperm(n, generator=generator, device=generator.device).tolist() if random_order \
            else range(n)
        return _apply(transforms, order, clip, generator)

    return apply


def one_of(transforms: Sequence[Transform]) -> Transform:
    """Apply exactly one randomly chosen transform (vidaug group.py:52-66)."""
    transforms = list(transforms)

    def apply(clip, generator):
        i = int(torch.randint(0, len(transforms), (), generator=generator, device=generator.device))
        return transforms[i](clip, generator)

    return apply


def some_of(transforms: Sequence[Transform], n: int, random_order: bool = True) -> Transform:
    """Apply a random n-subset (vidaug group.py:69-105)."""
    transforms = list(transforms)
    if n > len(transforms):
        raise ValueError(f"cannot pick {n} of {len(transforms)} transforms")

    def apply(clip, generator):
        pick = torch.randperm(len(transforms), generator=generator, device=generator.device)[:n].tolist()
        return _apply(transforms, pick if random_order else sorted(pick), clip, generator)

    return apply


def sometimes(p: float, transform: Transform) -> Transform:
    """Apply with probability p (vidaug group.py:108-133)."""

    def apply(clip, generator):
        if float(torch.rand((), generator=generator, device=generator.device)) < p:
            return transform(clip, generator)
        return clip

    return apply

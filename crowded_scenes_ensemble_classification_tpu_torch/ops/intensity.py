"""Pixel-intensity transforms (vidaug/augmentors/intensity.py equivalents).

Counterpart of `crowded_scenes_ensemble_classification_tpu/ops/intensity.py`
(lines 1-41).  Clips are float (T, H, W, C) tensors with values in
[0, 255].  `salt` and `pepper` draw their per-element hits from a
`torch.Generator` (on the clip's device); `salt_hits`/`pepper_hits` apply
given hits, the deterministic cores.
"""

from __future__ import annotations

import torch


def invert_color(clip: torch.Tensor) -> torch.Tensor:
    """255 − x (vidaug intensity.py:26-40)."""
    return 255.0 - clip


def add(clip: torch.Tensor, value: float) -> torch.Tensor:
    """x + value, clamped to [0, 255] (vidaug intensity.py:43-75)."""
    return torch.clamp(clip + value, 0.0, 255.0)


def multiply(clip: torch.Tensor, value: float) -> torch.Tensor:
    """x · value, clamped to [0, 255] (vidaug intensity.py:78-110)."""
    return torch.clamp(clip * value, 0.0, 255.0)


def noise_hits(clip: torch.Tensor, generator: torch.Generator, ratio: int = 100) -> torch.Tensor:
    """Bool hits of `clip`'s shape, each true with probability 1/ratio: a
    draw of randint(ratio) per element hitting 0, as the reference did."""
    draws = torch.randint(0, ratio, clip.shape, generator=generator, device=generator.device)
    return (draws == 0).to(clip.device)


def pepper_hits(clip: torch.Tensor, hits: torch.Tensor) -> torch.Tensor:
    """0 where `hits` (vidaug intensity.py:113-141)."""
    return torch.where(hits, torch.zeros((), dtype=clip.dtype, device=clip.device), clip)


def salt_hits(clip: torch.Tensor, hits: torch.Tensor) -> torch.Tensor:
    """255 where `hits` (vidaug intensity.py:143-171)."""
    return torch.where(hits, torch.full((), 255.0, dtype=clip.dtype, device=clip.device), clip)


def pepper(clip: torch.Tensor, generator: torch.Generator, ratio: int = 100) -> torch.Tensor:
    """Each element goes to 0 with probability 1/ratio."""
    return pepper_hits(clip, noise_hits(clip, generator, ratio))


def salt(clip: torch.Tensor, generator: torch.Generator, ratio: int = 100) -> torch.Tensor:
    """Each element goes to 255 with probability 1/ratio."""
    return salt_hits(clip, noise_hits(clip, generator, ratio))

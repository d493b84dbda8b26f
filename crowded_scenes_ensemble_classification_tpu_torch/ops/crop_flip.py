"""Spatial crop and flip transforms (vidaug crop.py / flip.py equivalents).

Counterpart of `crowded_scenes_ensemble_classification_tpu/ops/crop_flip.py`
(lines 1-88) on float (T, H, W, C) tensors.  The random crops draw their
window from a `torch.Generator`; `crop_at` is the deterministic core.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def horizontal_flip(clip: torch.Tensor) -> torch.Tensor:
    """Mirror the width axis (vidaug flip.py:20-32)."""
    return torch.flip(clip, dims=(2,))


def vertical_flip(clip: torch.Tensor) -> torch.Tensor:
    """Mirror the height axis (vidaug flip.py:36-48)."""
    return torch.flip(clip, dims=(1,))


def crop_at(clip: torch.Tensor, y0: int, x0: int, size_hw: Tuple[int, int]) -> torch.Tensor:
    """The (size_h, size_w) window at (y0, x0) of every frame."""
    return clip[:, y0:y0 + size_hw[0], x0:x0 + size_hw[1], :]


def _check_fits(clip: torch.Tensor, size_hw: Tuple[int, int]) -> None:
    if size_hw[0] > clip.shape[1] or size_hw[1] > clip.shape[2]:
        raise ValueError(f"crop {size_hw} larger than frame {tuple(clip.shape[1:3])}")


def center_crop(clip: torch.Tensor, size_hw: Tuple[int, int]) -> torch.Tensor:
    """Round-half-even centered window, Python's `int(round((dim − crop)/2))`
    (vidaug crop.py:36-37)."""
    _check_fits(clip, size_hw)
    _, h, w, _ = clip.shape
    return crop_at(clip, int(round((h - size_hw[0]) / 2.0)), int(round((w - size_hw[1]) / 2.0)), size_hw)


CORNER_POSITIONS = ("c", "tl", "tr", "bl", "br")


def corner_offsets(h: int, w: int, size_hw: Tuple[int, int]) -> dict:
    """Window origin (y0, x0) of each of the five positions."""
    ch, cw = size_hw
    return {
        "c": (int(round((h - ch) / 2.0)), int(round((w - cw) / 2.0))),
        "tl": (0, 0),
        "tr": (0, w - cw),
        "bl": (h - ch, 0),
        "br": (h - ch, w - cw),
    }


def corner_crop(
    clip: torch.Tensor,
    size_hw: Tuple[int, int],
    position: Optional[str] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Fixed-corner crop, or with position=None one of the five positions
    drawn from `generator` (vidaug crop.py:67-142)."""
    _, h, w, _ = clip.shape
    if position is None:
        if generator is None:
            raise ValueError("random corner crop needs a generator")
        position = CORNER_POSITIONS[int(torch.randint(0, len(CORNER_POSITIONS), (), generator=generator,
                                                      device=generator.device))]
    y0, x0 = corner_offsets(h, w, size_hw)[position]
    return crop_at(clip, y0, x0, size_hw)


def random_crop(clip: torch.Tensor, size_hw: Tuple[int, int], generator: torch.Generator) -> torch.Tensor:
    """Uniform window: y0 ∈ [0, H−ch], x0 ∈ [0, W−cw], inclusive (vidaug
    crop.py:145-191)."""
    _check_fits(clip, size_hw)
    _, h, w, _ = clip.shape
    draw = lambda n: int(torch.randint(0, n, (), generator=generator, device=generator.device))  # noqa: E731
    y0 = draw(h - size_hw[0] + 1)
    return crop_at(clip, y0, draw(w - size_hw[1] + 1), size_hw)

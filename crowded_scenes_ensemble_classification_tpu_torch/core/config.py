"""Clip geometry of the ported model families.

Restated from `crowded_scenes_ensemble_classification_tpu/core/config.py:47-69`
(reference define_input, train.py:1566-1616).  Only the I3D entry is ported;
the other model families raise `NotImplementedError` until they are
(ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# Model registry keys (JAX core/config.py:18-27, reference train.py:2076).
MODEL_TYPES = (
    "TWOSTREAM_I3D",
    "I3D",
    "C3D",
    "R3D_18",
    "R3D_34",
    "R3D_50",
    "R3D_101",
    "R3D_152",
)


@dataclasses.dataclass(frozen=True)
class ClipSpec:
    """Canonical clip geometry for a model family (JAX core/config.py:47-63)."""

    frames: int
    height: int
    width: int
    rgb_channels: int = 3

    @property
    def rgb_shape(self) -> Tuple[int, int, int, int]:
        return (self.frames, self.height, self.width, self.rgb_channels)


# JAX core/config.py:68
CLIP_SPECS = {
    "I3D": ClipSpec(frames=20, height=224, width=224),
}


def clip_spec(model_type: str) -> ClipSpec:
    """The canonical clip geometry of `model_type` (JAX core/config.py:79-83)."""
    if model_type in CLIP_SPECS:
        return CLIP_SPECS[model_type]
    if model_type in MODEL_TYPES:
        raise NotImplementedError(f"{model_type} is not ported yet (ROADMAP Queue 1 item 4)")
    raise ValueError(f"Unknown model_type {model_type!r}; valid: {MODEL_TYPES}")

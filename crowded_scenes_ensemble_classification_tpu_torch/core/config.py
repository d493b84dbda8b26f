"""Clip geometry of the ported model families.

Restated from `crowded_scenes_ensemble_classification_tpu/core/config.py:47-69`
(reference define_input, train.py:1566-1616).  Only the I3D entry is ported.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


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

"""Model types, weighting schemes and the clip geometry of every model family.

Restated from `crowded_scenes_ensemble_classification_tpu/core/config.py:18-83`
(reference define_input, train.py:1566-1616), and `split_pairs` (lines
237-245).  The experiment config and its legacy artifact names are not
ported yet (ROADMAP Queue 1 item 6).
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
# JAX core/config.py:36 (reference train.py:2143).  The port's member
# forwards take both: precomputed flow, or gray pairs for `flow.farneback`.
OPTICAL_FLOW_STATUSES = ("TVL1_precomputed", "FarneBack_onTheFly")
# JAX core/config.py:38-44 (reference evaluate_ensemble.py:1733).
WEIGHTING_SCHEMES = (
    "GRID_SEARCH",
    "DIFFERENTIAL_EVOLUTION",
    "SUM",
    "VALIDATION_ERROR_INVERSE",
    "MAXIMUM",
)


@dataclasses.dataclass(frozen=True)
class ClipSpec:
    """Canonical clip geometry for a model family (JAX core/config.py:47-63)."""

    frames: int
    height: int
    width: int
    rgb_channels: int = 3
    flow_channels: int = 0  # nonzero only for two-stream

    @property
    def rgb_shape(self) -> Tuple[int, int, int, int]:
        return (self.frames, self.height, self.width, self.rgb_channels)

    @property
    def flow_shape(self) -> Tuple[int, int, int, int]:
        return (self.frames, self.height, self.width, self.flow_channels)


# JAX core/config.py:67-76
CLIP_SPECS = {
    "I3D": ClipSpec(frames=20, height=224, width=224),
    "TWOSTREAM_I3D": ClipSpec(frames=20, height=224, width=224, flow_channels=2),
    "C3D": ClipSpec(frames=16, height=112, width=112),
    "R3D_18": ClipSpec(frames=16, height=112, width=112),
    "R3D_34": ClipSpec(frames=16, height=112, width=112),
    "R3D_50": ClipSpec(frames=16, height=112, width=112),
    "R3D_101": ClipSpec(frames=16, height=112, width=112),
    "R3D_152": ClipSpec(frames=16, height=112, width=112),
}


def clip_spec(model_type: str) -> ClipSpec:
    """The canonical clip geometry of `model_type` (JAX core/config.py:79-83)."""
    try:
        return CLIP_SPECS[model_type]
    except KeyError:
        raise ValueError(f"Unknown model_type {model_type!r}; valid: {MODEL_TYPES}") from None


def split_pairs(folds_number: int):
    """All (test_index, val_index) pairs of the k×(k−1) split matrix (JAX
    core/config.py:237-245, reference launch_train_ensemble.py:117-127)."""
    return [(t, v) for t in range(folds_number) for v in range(folds_number) if v != t]

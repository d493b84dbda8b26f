"""Typed experiment configuration: model types, weighting schemes, the clip
geometry of every model family and `ExperimentConfig`.

Restated from `crowded_scenes_ensemble_classification_tpu/core/config.py`
(the whole module; reference define_input, train.py:1566-1616, and the
train.py CLI, :2064-2165).  `ExperimentConfig` generates the reference's
legacy artifact names (its filesystem protocol between stages) string for
string as the JAX package does, and its JSON loads in either package.
"""

from __future__ import annotations

import dataclasses
import json
import os
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
# JAX core/config.py:29-34 (reference train.py:2083, :2089, :2128).
TRAINING_CONDITIONS = ("_SCRATCH", "_PRETRAINED")
CLASSES_STATUSES = ("balanced", "unbalanced")
AUGMENTATION_STATUSES = ("non_augmented", "augmented_onTheFly", "augmented_precomputed")
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


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """One experiment = (architecture, training condition, data pipeline
    flags), the fields of JAX core/config.py:87-142 with its defaults.

    `compute_dtype` names the dtype the port's members compute in
    ("bfloat16" or "float32"): `orchestration.train_member` trains f32
    master weights computing in it, and `cache_probabilities` runs the
    members in it.  `data_axis` and `member_axis` name mesh axes; they are
    kept so the JSON round-trips, and nothing reads them until the mesh is
    ported (ROADMAP Queue 1 item 7)."""

    model_type: str = "C3D"
    training_condition: str = "_SCRATCH"
    folds_number: int = 5
    classes_status: str = "unbalanced"
    augmentation_status: str = "non_augmented"
    augmentation_frequency: int = 1
    optical_flow_status: str = "FarneBack_onTheFly"
    num_classes: int = 11  # Crowd-11
    batch_size: int = 16
    epochs: int = 100
    compute_dtype: str = "bfloat16"
    data_axis: str = "data"
    member_axis: str = "member"
    # Pixel pre-scale of the model inputs (1.0 = the reference's raw 0-255
    # floats, train.py:283-289): training and probability caching both read
    # it from here.
    input_scale: float = 1.0
    # TwoStream on-the-fly Farnebäck from the augmented frames (reference
    # train.py:176-184) instead of the unaugmented staged ones.
    flow_from_augmented: bool = False
    # Farnebäck schedule for FarneBack_onTheFly runs: 'full' or 'turbo'
    # (`flow.farneback.flow_schedule_params`).
    flow_schedule: str = "full"

    def __post_init__(self):
        for value, allowed, name in (
            (self.model_type, MODEL_TYPES, "model_type"),
            (self.training_condition, TRAINING_CONDITIONS, "training_condition"),
            (self.augmentation_status, AUGMENTATION_STATUSES, "augmentation_status"),
            (self.optical_flow_status, OPTICAL_FLOW_STATUSES, "optical_flow_status"),
            (self.flow_schedule, ("full", "turbo"), "flow_schedule"),
        ):
            if value not in allowed:
                raise ValueError(f"{name} {value!r} not in {allowed}")
        if self.folds_number < 3:
            # every (test, val) pair must leave ≥1 train fold (JAX config.py:151-160)
            raise ValueError(
                f"folds_number must be ≥3 (got {self.folds_number}): the k·(k−1) member grid needs at least "
                "one training fold per (test, validation) pair"
            )

    # Legacy artifact naming (write-only; reference train.py:1983-2008).

    @property
    def clip(self) -> ClipSpec:
        return clip_spec(self.model_type)

    @property
    def is_two_stream(self) -> bool:
        return self.model_type == "TWOSTREAM_I3D"

    def subfolder_name(self) -> str:
        """`{k}folds_{MODEL}{COND}_CS_{cs}_OF_{of}_AS_{as}`."""
        return (
            f"{self.folds_number}folds_{self.model_type}{self.training_condition}"
            f"_CS_{self.classes_status}_OF_{self.optical_flow_status}_AS_{self.augmentation_status}"
        )

    def split_suffix(self, test_index: int, val_index: int) -> str:
        return f"_split_test{test_index}_val{val_index}"

    def artifact_stem(self, test_index: int, val_index: int) -> str:
        """Basename of all per-split artifacts (weights/history/probabilities)."""
        stem = self.subfolder_name()
        if self.augmentation_status == "augmented_precomputed":
            stem += f"_Freq{self.augmentation_frequency}"
        return stem + self.split_suffix(test_index, val_index)

    def weights_relpath(self, test_index: int, val_index: int) -> str:
        """The per-split checkpoint directory, `{subfolder}/TestSplit{t}/{stem}_weights`
        (reference train.py:1996-2008, :1850-1853)."""
        return os.path.join(self.subfolder_name(), f"TestSplit{test_index}",
                            self.artifact_stem(test_index, val_index) + "_weights")

    def history_relpath(self, test_index: int, val_index: int) -> str:
        """The val-loss history artifact (reference store_history, train.py:63-82)."""
        return os.path.join(self.subfolder_name(), f"TestSplit{test_index}",
                            self.artifact_stem(test_index, val_index) + "_validation_losses.npy")

    # Serialization (the JAX package's JSON, key for key).

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentConfig":
        return cls(**json.loads(text))

    def save(self, path: str) -> None:
        """Write atomically: member processes may save the same config at once."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(self.to_json())
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "ExperimentConfig":
        with open(path) as f:
            return cls.from_json(f.read())


def split_pairs(folds_number: int):
    """All (test_index, val_index) pairs of the k×(k−1) split matrix (JAX
    core/config.py:237-245, reference launch_train_ensemble.py:117-127)."""
    return [(t, v) for t in range(folds_number) for v in range(folds_number) if v != t]


def member_val_indices(folds_number: int, test_index: int):
    """Validation indices of the k−1 members of test fold `test_index`'s
    homogeneous ensemble (JAX core/config.py:248-251)."""
    return [v for v in range(folds_number) if v != test_index]

"""Experiment artifact manifest.

Counterpart of `crowded_scenes_ensemble_classification_tpu/core/manifest.py`
(lines 1-108), restated because that package's `__init__` imports jax: the
same JSON, key for key, apart from the `saved_at` timestamp.

It replaces the reference's implicit L7 "filesystem naming protocol" — where
training and evaluation communicated through regex-parsed directory names,
stringified-numpy CSVs (evaluate_ensemble.py:65-73) and loose .npy files —
with one typed JSON manifest per experiment that records every artifact
(checkpoints, histories, probability tensors, reports) with its role,
split indices, and format.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

from .config import ExperimentConfig


@dataclasses.dataclass
class ArtifactRecord:
    kind: str  # "checkpoint" | "history" | "probabilities" | "report" | "fold_csv" | "weights"
    path: str  # relative to the manifest root
    test_index: Optional[int] = None
    val_index: Optional[int] = None
    fmt: str = "npz"
    meta: Dict = dataclasses.field(default_factory=dict)


class Manifest:
    """JSON-backed artifact registry rooted at an experiment directory."""

    FILENAME = "manifest.json"

    def __init__(self, root: str, config: Optional[ExperimentConfig] = None):
        self.root = root
        self.config = config
        self.records: List[ArtifactRecord] = []
        os.makedirs(root, exist_ok=True)

    # -- persistence ----------------------------------------------------

    @property
    def path(self) -> str:
        return os.path.join(self.root, self.FILENAME)

    def save(self) -> None:
        payload = {
            "saved_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "config": None if self.config is None else json.loads(self.config.to_json()),
            "records": [dataclasses.asdict(r) for r in self.records],
        }
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2)
        os.replace(tmp, self.path)

    @classmethod
    def load(cls, root: str) -> "Manifest":
        with open(os.path.join(root, cls.FILENAME)) as f:
            payload = json.load(f)
        cfg = None
        if payload.get("config"):
            cfg = ExperimentConfig(**payload["config"])
        m = cls(root, cfg)
        m.records = [ArtifactRecord(**r) for r in payload.get("records", [])]
        return m

    # -- registry -------------------------------------------------------

    def add(self, record: ArtifactRecord, save: bool = True) -> ArtifactRecord:
        # idempotent: replace a record with the same identity
        self.records = [
            r
            for r in self.records
            if not (
                r.kind == record.kind
                and r.test_index == record.test_index
                and r.val_index == record.val_index
                and r.path == record.path
            )
        ]
        self.records.append(record)
        if save:
            self.save()
        return record

    def find(
        self,
        kind: str,
        test_index: Optional[int] = None,
        val_index: Optional[int] = None,
    ) -> List[ArtifactRecord]:
        out = []
        for r in self.records:
            if r.kind != kind:
                continue
            if test_index is not None and r.test_index != test_index:
                continue
            if val_index is not None and r.val_index != val_index:
                continue
            out.append(r)
        return out

    def abspath(self, record: ArtifactRecord) -> str:
        return os.path.join(self.root, record.path)

"""Host-side dataset helpers.

Counterpart of part of `crowded_scenes_ensemble_classification_tpu/data/pipeline.py`:
only `class_weights_balanced` (lines 261-267) so far.  `BatchPipeline` and
`prefetch_batches` wait for the decode path (ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def class_weights_balanced(labels: Sequence[int], num_classes: int) -> np.ndarray:
    """sklearn-style 'balanced' weights, n / (k · bincount), 0 for an absent
    class (reference train.py:1900-1912 used sklearn.compute_class_weight)."""
    counts = np.bincount(np.asarray(labels, np.int64), minlength=num_classes)
    n = len(labels)
    w = np.where(counts > 0, n / (num_classes * np.maximum(counts, 1)), 0.0)
    return w.astype(np.float32)

"""Frame selection on the host.

Counterpart of `select_frame_indices` in
`crowded_scenes_ensemble_classification_tpu/ops/temporal.py:29-36`, restated
because that module imports jax.  The decoder (`data/video_io.py`) and the
`.npy` loader (`data/pipeline.py`) pick their frames with it.  The rest of
that module, the vidaug temporal augmenters, is not ported yet (ROADMAP
Queue 1 item 5).
"""

from __future__ import annotations

import numpy as np


def select_frame_indices(num_frames: int, n: int) -> np.ndarray:
    """Stride-subsample indices: step = max(T//n, 1), first n of every
    step-th frame (reference select_frames train.py:132-145).  For clips
    shorter than n the reference under-fills; this cycles (idx % T) so the
    output length is always n."""
    step = max(num_frames // n, 1)
    idx = np.arange(n) * step
    return idx % num_frames

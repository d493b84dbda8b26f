"""Device-resident dataset: upload staged uint8 clips once, gather batches on the device.

Counterpart of `crowded_scenes_ensemble_classification_tpu/data/resident.py`
(`ResidentClips`, lines 112-335) on one device.  The staged arrays cross the
host→device link once; every later step ships only its (B,) int32 row
indices and valid mask, and `train.engine.make_resident_train_step` gathers
the rows on the device.  A staged Crowd-11 clip is 20·256²·3 uint8 ≈ 3.9 MB,
so the card's 80 GB holds about twenty thousand of them.

Left out, with their reasons: `FlatRows`, which works around the TPU's
(8, 128) tile padding of a 3-wide lane dimension (a dense uint8 tensor pads
nothing here), and the sharded gather over the mesh, part 2 of the port's
distribution (ROADMAP Queue 1 items 8 and 9).  Per-epoch batching keeps the JAX class's
rules exactly, as one shard: the same pools, shuffles, padding and ids for
the same (seed, epoch, preshuffle, pad_to).  `from_pipeline` fills it from
a `BatchPipeline` (decode or clip cache) once.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ..utils.device import resolve_device


class ResidentClips:
    """Device-resident staged samples + per-epoch index batching.

    `arrays` maps staging names ("rgb") to (N, ...) numpy arrays; `labels`
    is (N,) int.  Batches from :meth:`batches` refer to the SAME resident
    device tensors every step: only `indices`/`valid` (B elements) are new
    host data.  Pairs with `train.engine.fit`, `evaluate_model` and the
    resident steps: exposes `df` (the balanced-class hook, `df["class"]`),
    `__len__` and `batches(epoch)`.  The arrays live on `device`: the card
    when None."""

    def __init__(
        self,
        arrays: Dict[str, np.ndarray],
        labels,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        augmentation_frequency: int = 1,
        drop_last: bool = False,
        preshuffle: Optional[int] = None,
        pad_to: Optional[int] = None,
        device=None,
    ):
        """preshuffle: seed of a one-time permutation of the rows, as the
        JAX class applies before its shard split; `index` still reports
        the original clip ids.  pad_to: pad the resident arrays with cycled
        rows up to this many, so that datasets of several sizes give one
        resident shape; pad rows are never valid."""
        labels = np.asarray(labels, np.int32)
        n = len(labels)
        if n == 0:
            raise ValueError("empty dataset")
        for k, v in arrays.items():
            if len(v) != n:
                raise ValueError(f"array {k!r} has {len(v)} rows, labels {n}")
        if preshuffle is not None:
            perm = np.random.default_rng(preshuffle).permutation(n)
            arrays = {k: np.asarray(v)[perm] for k, v in arrays.items()}
            labels = labels[perm]
            self._orig_ids = perm.astype(np.int64)
        else:
            self._orig_ids = np.arange(n, dtype=np.int64)
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.tile = max(augmentation_frequency, 1)
        self.drop_last = drop_last
        self.device = resolve_device(device)
        self.n_padded = max(n, pad_to or 0)
        pad_idx = np.arange(self.n_padded) % n  # cycles even when pad > n

        def put(a) -> torch.Tensor:
            a = np.asarray(a)
            if self.n_padded != n:
                a = a[pad_idx]
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        self.resident = {k: put(v) for k, v in arrays.items()}
        self.resident["label"] = put(labels)
        self.df = {"class": labels}  # balanced-class hook: fit reads df["class"]

    @classmethod
    def from_pipeline(
        cls,
        pipeline,
        batch_size: Optional[int] = None,
        preshuffle: Optional[int] = None,
        pad_to: Optional[int] = None,
        device=None,
    ) -> "ResidentClips":
        """Materialise a `data.pipeline.BatchPipeline`'s staged samples once
        and pin them on `device` (the card when None): decoded by the
        pipeline's thread pool, or read from its clip cache by the native
        threaded pread once populated (JAX resident.py:226-272).  Shuffle,
        seed, `augmentation_frequency` tiling and `drop_last` carry over."""
        import concurrent.futures as cf

        df = pipeline.df
        pipeline.populate()
        if pipeline.cached:
            rgb, labels = pipeline.source.read_batch(np.arange(len(df)))
            arrays = {"rgb": rgb}
        else:
            src = pipeline.source
            with cf.ThreadPoolExecutor(max_workers=pipeline.num_workers) as pool:
                samples = list(pool.map(lambda i: src(df.row(i)), range(len(df))))
            arrays = {k: np.stack([s[k] for s in samples]) for k in samples[0] if k != "label"}
            labels = [s["label"] for s in samples]
        return cls(
            arrays,
            np.asarray(labels, np.int32),
            batch_size or pipeline.batch_size,
            shuffle=pipeline.shuffle,
            seed=pipeline.seed,
            augmentation_frequency=pipeline.tile,
            drop_last=pipeline.drop_last,
            preshuffle=preshuffle,
            pad_to=pad_to,
            device=device,
        )

    @property
    def nbytes(self) -> int:
        """Device footprint of the resident tensors."""
        return sum(v.numel() * v.element_size() for v in self.resident.values())

    def __len__(self) -> int:
        pool = self.n * self.tile
        return pool // self.batch_size if self.drop_last else math.ceil(pool / self.batch_size)

    def epoch_local_indices(self, epoch: int) -> List[np.ndarray]:
        """The epoch's pool of row ids (real rows only, tiled
        `augmentation_frequency` times), shuffled deterministically in
        (seed, epoch); a list of one pool, the JAX class's one shard."""
        pool = np.tile(np.arange(self.n, dtype=np.int32), self.tile)
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(pool)
        return [pool]

    def batches(self, epoch: int = 0) -> Iterator[Dict]:
        """Yields {"resident": {name → (N_padded, …) device tensor, "label"
        incl.}, "indices": (B,) int32 row ids, "valid": (B,) bool,
        "index": (B,) int64 original clip ids}; a short last batch is
        padded by cycling the pool and masked invalid."""
        (pool,) = self.epoch_local_indices(epoch)
        bs = self.batch_size
        for b in range(len(self)):
            chunk = pool[b * bs : (b + 1) * bs]
            valid = np.zeros(bs, bool)
            valid[: len(chunk)] = True
            if len(chunk) < bs:
                chunk = np.resize(np.concatenate([chunk, pool]), bs)
            yield {
                "resident": self.resident,
                "indices": chunk.astype(np.int32),
                "valid": valid,
                "index": self._orig_ids[chunk.astype(np.int64) % self.n],
            }

"""Device-resident dataset: upload staged uint8 clips once, gather batches on the device.

Counterpart of `crowded_scenes_ensemble_classification_tpu/data/resident.py`
(`ResidentClips`, lines 112-335).  The staged arrays cross the host→device
link once; every later step ships only its (B,) int32 row indices and valid
mask, and `train.engine.make_resident_train_step` gathers the rows on the
device.  A staged Crowd-11 clip is 20·256²·3 uint8 ≈ 3.9 MB, so the card's
80 GB holds about twenty thousand of them.

With a `mesh` the dataset is split over its data axis as in JAX: after the
one-time preshuffle, position i holds the contiguous rows [i·R, (i+1)·R) on
its device (the dataset padded with cycled rows to a multiple of the
shards, pad rows never valid), and `batches(epoch)` yields per-shard local
indices, shard-block-major, which the mesh steps gather from each
position's own rows; `index` gives the original clip ids.  Without one,
the rules are the JAX class's with one shard.

`from_pipeline` fills it from a `BatchPipeline` (decode or clip cache)
once.  `FlatRows` (JAX resident.py:54-110) is the flat (N, K) view of
logically (N, *row_shape) rows, with JAX's host conveniences; the card pads
no small last dimension, so `ResidentClips` keeps its dense tensors.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core.mesh import Mesh
from ..utils.device import resolve_device


class FlatRows:
    """(N, K) flat storage of logically (N, *row_shape) samples (JAX
    data/resident.py:54-110): `densify()` is the (N, *row_shape) view,
    and `shape`, `dtype`, `nbytes`, `len`, indexing (one dense row) and
    `__array__` present the logical dense view."""

    def __init__(self, flat: torch.Tensor, row_shape: Tuple[int, ...]):
        self.flat = flat
        self.row_shape = tuple(int(s) for s in row_shape)

    def densify(self) -> torch.Tensor:
        return self.flat.reshape((self.flat.shape[0],) + self.row_shape)

    @property
    def shape(self) -> Tuple[int, ...]:
        return (int(self.flat.shape[0]),) + self.row_shape

    @property
    def dtype(self) -> torch.dtype:
        return self.flat.dtype

    @property
    def nbytes(self) -> int:
        return self.flat.numel() * self.flat.element_size()

    def __len__(self) -> int:
        return int(self.flat.shape[0])

    def __getitem__(self, i) -> torch.Tensor:
        return self.flat[i].reshape(self.row_shape)

    def __array__(self, dtype=None, copy=None):
        dense = self.densify().cpu().numpy()
        return dense.astype(dtype) if dtype is not None else dense


class ResidentClips:
    """Device-resident staged samples + per-epoch index batching.

    `arrays` maps staging names ("rgb") to (N, ...) numpy arrays; `labels`
    is (N,) int.  Batches from :meth:`batches` refer to the SAME resident
    device tensors every step: only `indices`/`valid` (B elements) are new
    host data.  Pairs with `train.engine.fit`, `evaluate_model` and the
    resident steps: exposes `df` (the balanced-class hook, `df["class"]`),
    `__len__` and `batches(epoch)`.  The arrays live on `device` (the card
    when None), or, with a `mesh`, shard i on position i of its
    `data_axis`: then each resident entry is a list of `n_shards` tensors."""

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
        mesh: Optional[Mesh] = None,
        data_axis: str = "data",
    ):
        """preshuffle: seed of a one-time permutation of the rows before
        the contiguous shard split (fold CSVs are class-clustered, so
        without it each shard would hold a class-skewed subset); `index`
        still reports the original clip ids.  pad_to: pad the resident
        arrays with cycled rows up to at least this many (and to a multiple
        of the shards), so that datasets of several sizes give one resident
        shape; pad rows are never valid.  mesh: shard over its `data_axis`
        (batch_size must divide by its size); `device` must then be None."""
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
        self.mesh = mesh
        self.data_axis = data_axis
        if mesh is not None:
            if device is not None:
                raise ValueError("a sharded ResidentClips lives on its mesh's devices: give mesh or device, not both")
            devices = mesh.axis_devices(data_axis)
            self.n_shards = len(devices)
            if batch_size % self.n_shards:
                raise ValueError(f"batch_size {batch_size} not divisible by {self.n_shards} shards")
            self.device = devices[0]
        else:
            self.n_shards = 1
            self.device = resolve_device(device)
        # Pad to a multiple of n_shards (and at least pad_to) with cycled
        # rows: pad rows make the shards' extents equal, and no epoch pool
        # holds them.
        target = max(n, pad_to or 0)
        self.n_padded = math.ceil(target / self.n_shards) * self.n_shards
        pad_idx = np.arange(self.n_padded) % n  # cycles even when pad > n
        rows = self.n_padded // self.n_shards
        self._shard_rows = rows

        def put(a):
            a = np.asarray(a)
            if self.n_padded != n:
                a = a[pad_idx]
            if mesh is None:
                return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            return [torch.from_numpy(np.ascontiguousarray(a[i * rows:(i + 1) * rows])).to(d)
                    for i, d in enumerate(devices)]

        self.resident = {k: put(v) for k, v in arrays.items()}
        self.resident["label"] = put(labels)
        # per-shard count of real rows (pad rows sit at the global tail)
        self._real_per_shard = np.clip(n - rows * np.arange(self.n_shards), 0, rows).astype(int)
        self.df = {"class": labels}  # balanced-class hook: fit reads df["class"]

    @classmethod
    def from_pipeline(
        cls,
        pipeline,
        batch_size: Optional[int] = None,
        preshuffle: Optional[int] = None,
        pad_to: Optional[int] = None,
        device=None,
        mesh: Optional[Mesh] = None,
        data_axis: str = "data",
    ) -> "ResidentClips":
        """Materialise a `data.pipeline.BatchPipeline`'s staged samples once
        and pin them on `device` (the card when None), or shard them over
        `mesh`: decoded by the pipeline's thread pool, or read from its clip
        cache by the native threaded pread once populated (JAX
        resident.py:226-272).  Shuffle, seed, `augmentation_frequency`
        tiling and `drop_last` carry over."""
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
            mesh=mesh,
            data_axis=data_axis,
        )

    @property
    def nbytes(self) -> int:
        """Device footprint of the resident tensors (every shard)."""
        return sum(t.numel() * t.element_size() for v in self.resident.values()
                   for t in (v if isinstance(v, list) else [v]))

    @property
    def _shard_bs(self) -> int:
        return self.batch_size // self.n_shards

    def __len__(self) -> int:
        pool = int(self._real_per_shard.max()) * self.tile
        return pool // self._shard_bs if self.drop_last else math.ceil(pool / self._shard_bs)

    def epoch_local_indices(self, epoch: int) -> List[np.ndarray]:
        """Per-shard pools of local row ids (real rows only, tiled
        `augmentation_frequency` times), shuffled deterministically in
        (seed, epoch), one generator over the shards in order (JAX
        resident.py:296-311)."""
        rng = np.random.default_rng((self.seed, epoch)) if self.shuffle else None
        pools = []
        for d in range(self.n_shards):
            pool = np.tile(np.arange(self._real_per_shard[d], dtype=np.int32), self.tile)
            if rng is not None and len(pool):
                rng.shuffle(pool)
            pools.append(pool)
        return pools

    def batches(self, epoch: int = 0) -> Iterator[Dict]:
        """Yields {"resident": {name → (N_padded, …) device tensor, or the
        list of shards, "label" incl.}, "indices": (B,) int32 local row ids
        in shard-block order, "valid": (B,) bool, "index": (B,) int64
        original clip ids}; a shard's short last block is padded by cycling
        its pool and masked invalid (JAX resident.py:313-335)."""
        pools = self.epoch_local_indices(epoch)
        pbs = self._shard_bs
        for b in range(len(self)):
            idx = np.zeros((self.n_shards, pbs), np.int32)
            valid = np.zeros((self.n_shards, pbs), bool)
            for d, pool in enumerate(pools):
                chunk = pool[b * pbs : (b + 1) * pbs]
                valid[d, : len(chunk)] = True
                if len(chunk) < pbs:
                    fill = pool if len(pool) else np.zeros(1, np.int32)
                    chunk = np.resize(np.concatenate([chunk, fill]), pbs)
                idx[d] = chunk
            glob = idx.astype(np.int64) + (self._shard_rows * np.arange(self.n_shards, dtype=np.int64))[:, None]
            yield {
                "resident": self.resident,
                "indices": idx.reshape(-1),
                "valid": valid.reshape(-1),
                "index": self._orig_ids[glob.reshape(-1) % self.n],
            }

"""The host input pipeline: clip table → staged uint8 batches, decoded ahead of the card.

Counterpart of `crowded_scenes_ensemble_classification_tpu/data/pipeline.py`
(lines 37-267), which replaces the reference `DataGenerator
(keras.utils.Sequence)` (train.py:361-488):

- per-epoch shuffling from an explicit `np.random.default_rng((seed,
  epoch))`, the JAX stream, so both packages visit the same rows in the
  same order (the reference shuffled with the global RNG in on_epoch_end,
  train.py:413-419);
- `augmentation_frequency` tiling of the index list for on-the-fly
  augmentation (train.py:380-383, 416-417): every tiled copy is a row of
  its own, augmented afresh by the train step;
- the last partial batch padded by cycling its rows and reported through a
  `valid` mask (the reference fed uninitialised np.empty rows,
  train.py:428-434), with each row's clip id in `index`;
- a thread pool that decodes and stages clips (`data/video_io.py`, cv2),
  or, with `cache_file`, the native clip cache (`data/clip_cache.py`)
  after the first pass;
- `prefetch_batches`, a producer thread that keeps batches queued while the
  card runs the step on the one before.

Batches are host dicts of uint8 numpy arrays (`rgb`, and for two-stream
`flow` or `gray`/`gray_next`; `label`, `valid`, `index`); the consumers
(`ensemble.members.member_probabilities`, `calibrate_members`,
`train.engine.fit`, `evaluate_model`) move them to their module's device,
where all pixel math runs.  `iterate_batches` is how they read any source.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import math
import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.temporal import select_frame_indices
from .table import ClipTable, concat
from .video_io import decode_clip, decode_flow_pair, decode_twostream_staging

_CLIP_COLUMNS = ["x_axis_flowclips_path", "y_axis_flowclips_path", "class"]


def expand_precomputed_augmentation(df: ClipTable, augmentation_frequency: int) -> ClipTable:
    """Merge the rgbclips_augmented_{i}_path columns into extra rows: the
    reference `augment_dataframe` (train.py:99-125)."""
    parts = [df.select(["rgbclips_path", *_CLIP_COLUMNS])]
    for i in range(augmentation_frequency):
        col = f"rgbclips_augmented_{i}_path"
        if col not in df:
            raise KeyError(f"missing augmented column {col}")
        parts.append(df.select([col, *_CLIP_COLUMNS]).rename({col: "rgbclips_path"}))
    return concat(parts)


def _load_array(path: str, num_frames: int, staging_hw, gray: bool = False) -> np.ndarray:
    """A `.npy` clip (frames selected, resized by cv2 to the staging), or a
    video decoded by `decode_clip`."""
    if not path.endswith(".npy"):
        return decode_clip(path, num_frames, staging_hw, gray=gray)
    clip = np.load(path)
    clip = clip[select_frame_indices(clip.shape[0], num_frames)]
    if staging_hw is not None and clip.shape[1:3] != tuple(staging_hw):
        try:
            import cv2
        except ImportError:
            raise RuntimeError("resize of .npy clips requires cv2") from None
        clip = np.stack([cv2.resize(f, (staging_hw[1], staging_hw[0])) for f in clip])
        if clip.ndim == 3:
            clip = clip[..., None]
    return clip


@dataclass
class SampleSpec:
    """What to stage per clip."""

    num_frames: int
    staging_hw: Tuple[int, int]
    two_stream: bool = False
    flow_precomputed: bool = True  # else: gray frame pairs staged for Farnebäck on the card


class ClipSource:
    """Row → staged numpy sample: rgb; rgb and the precomputed flow pair;
    or, for two-stream without precomputed flow, rgb and the gray pairs of
    one decode pass (`decode_twostream_staging`)."""

    def __init__(self, spec: SampleSpec):
        self.spec = spec

    def __call__(self, row) -> Dict[str, np.ndarray]:
        s = self.spec
        if s.two_stream and not s.flow_precomputed:
            staged = decode_twostream_staging(row["rgbclips_path"], s.num_frames, s.staging_hw)
            staged["label"] = np.int32(row["class"])
            return staged
        out: Dict[str, np.ndarray] = {
            "rgb": _load_array(row["rgbclips_path"], s.num_frames, s.staging_hw),
            "label": np.int32(row["class"]),
        }
        if s.two_stream:
            out["flow"] = decode_flow_pair(row["x_axis_flowclips_path"], row["y_axis_flowclips_path"],
                                           s.num_frames, s.staging_hw)
        return out


class BatchPipeline:
    """Epoch iterator over a clip table yielding uniform uint8 batches with
    a validity mask."""

    def __init__(
        self,
        df: ClipTable,
        spec: SampleSpec,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        augmentation_frequency: int = 1,
        num_workers: int = 8,
        drop_last: bool = False,
        cache_file: Optional[str] = None,
    ):
        """df: rows with rgbclips_path, the x/y flow paths and class.
        cache_file: a native clip-cache shard (`data.clip_cache`), for
        one-stream rgb pipelines: the first pass populates it, later epochs
        stream from it by threaded pread."""
        self.df = df
        self.spec = spec
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.tile = max(augmentation_frequency, 1)
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.source = ClipSource(spec)
        if cache_file is not None:
            if spec.two_stream:
                raise ValueError("clip cache supports one-stream rgb pipelines")
            from .clip_cache import CachingClipSource

            self.source = CachingClipSource(self.source, self.df, cache_file, num_threads=num_workers)

    def __len__(self) -> int:
        n = len(self.df) * self.tile
        if self.drop_last:
            return n // self.batch_size
        return math.ceil(n / self.batch_size)

    def epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.tile(np.arange(len(self.df)), self.tile)
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(idx)
        return idx

    @property
    def cached(self) -> bool:
        """Whether batches come from a finished clip-cache shard."""
        return getattr(self.source, "ready", False)

    def populate(self) -> None:
        """Fill the clip cache, if the pipeline has one and it is not full."""
        if hasattr(self.source, "populate") and not self.source.ready:
            self.source.populate()

    def batches(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        self.populate()
        idx = self.epoch_indices(epoch)
        bs = self.batch_size
        cached = self.cached

        def load(i: int) -> Dict[str, np.ndarray]:
            return self.source(self.df.row(i))

        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for b in range(len(self)):
                chunk = idx[b * bs : (b + 1) * bs]
                valid = len(chunk)
                if valid < bs:  # pad by cycling (masked out downstream)
                    chunk = np.resize(chunk, bs)
                if cached:
                    rgb, labels = self.source.read_batch(chunk)
                    batch = {"rgb": rgb, "label": labels}
                else:
                    samples = list(pool.map(load, chunk))
                    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
                batch["valid"] = np.arange(bs) < valid
                batch["index"] = np.asarray(chunk, np.int64)
                yield batch


def prefetch_batches(pipeline: BatchPipeline, epoch: int = 0, depth: int = 2):
    """Run `pipeline.batches(epoch)` on a background thread, keeping up to
    `depth` batches queued: decoding batch k+1 overlaps the card's step on
    batch k (the reference relied on fit_generator's worker threads,
    train.py:1904-1921).  A consumer that stops early (or closes the
    generator) stops the producer and joins it; an error in the producer is
    raised in the consumer after the batches before it."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    err: List[BaseException] = []
    stop = threading.Event()  # the consumer is gone: unblock and end the producer

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in pipeline.batches(epoch):
                if not _put(batch):
                    return  # the consumer left: end mid-epoch, closing the decode pool
        except BaseException as e:  # noqa: BLE001 (re-raised in the consumer)
            err.append(e)
        finally:
            _put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    done = False
    try:
        while True:
            item = q.get()
            if item is sentinel:
                done = True
                break
            yield item
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join()
    if done and err:
        raise err[0]


@contextlib.contextmanager
def iterate_batches(source, epoch: int = 0):
    """`with iterate_batches(source, epoch) as batches:` the batches of one
    epoch of any source the consumers take: a `BatchPipeline` through
    `prefetch_batches`; anything with `batches(epoch)` (a `ResidentClips`)
    through that; any other iterable of batch dicts as it is.  On leaving
    the block an iterator made here is closed, so a consumer that stops
    early leaves no producer thread running; a caller's own iterable is
    left as it is."""
    if isinstance(source, BatchPipeline):
        it = prefetch_batches(source, epoch)
    elif hasattr(source, "batches"):
        it = source.batches(epoch)
    else:
        yield iter(source)
        return
    try:
        yield it
    finally:
        close = getattr(it, "close", None)  # a generator's; a plain iterator has none
        if close is not None:
            close()


def class_weights_balanced(labels: Sequence[int], num_classes: int) -> np.ndarray:
    """sklearn-style 'balanced' weights, n / (k · bincount), 0 for an absent
    class (reference train.py:1900-1912 used sklearn.compute_class_weight)."""
    counts = np.bincount(np.asarray(labels, np.int64), minlength=num_classes)
    n = len(labels)
    w = np.where(counts > 0, n / (num_classes * np.maximum(counts, 1)), 0.0)
    return w.astype(np.float32)

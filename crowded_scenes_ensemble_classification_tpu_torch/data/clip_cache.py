"""The native clip cache: decode once, then stream staged clips back with threaded pread.

Counterpart of `crowded_scenes_ensemble_classification_tpu/data/clip_cache.py`
(lines 1-232).  The C++ library (`native/clipcache.cpp` in this package, a
copy of the JAX package's) packs staged uint8 clips into one shard file and
reads them back with multi-threaded pread outside the GIL: the decode-once
answer to the reference's decode-every-epoch loop (train.py:160-172,
257-269).  The shard format is the JAX one, so each package reads the
other's shards.

Build: `g++ -O3 -std=c++17 -shared -fPIC -pthread` at first use, into
`<repo>/build/native/`, named by a hash of the source and flags (a changed
source rebuilds), and loaded with ctypes (a plain C interface).  Nothing is
built at import.  A failed build raises: nothing falls back to decoding.

Pipeline integration: `CachingClipSource` wraps a `ClipSource`; the first
pass decodes and populates the shard, later passes read it.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .table import ClipTable

SOURCE = Path(__file__).resolve().parents[1] / "native" / "clipcache.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_LIB_LOCK = threading.Lock()
_LIB = None


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libclipcache_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile the source unless its library exists; returns its path.
    Raises if g++ is missing or fails."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        so = os.path.join(tmp, lib.name)
        cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", so]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(so, lib)  # atomic: a concurrent build never loads a partial file
    return lib


def _load_library():
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build_library()))
        lib.cc_writer_open.restype = ctypes.c_void_p
        lib.cc_writer_open.argtypes = [ctypes.c_char_p]
        lib.cc_writer_add.restype = ctypes.c_int
        lib.cc_writer_add.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_int32,
        ]
        lib.cc_writer_finish.restype = ctypes.c_int
        lib.cc_writer_finish.argtypes = [ctypes.c_void_p]
        lib.cc_open.restype = ctypes.c_void_p
        lib.cc_open.argtypes = [ctypes.c_char_p]
        lib.cc_num_clips.restype = ctypes.c_int64
        lib.cc_num_clips.argtypes = [ctypes.c_void_p]
        lib.cc_clip_shape.restype = ctypes.c_int
        lib.cc_clip_shape.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint32)]
        lib.cc_read_clip.restype = ctypes.c_int
        lib.cc_read_clip.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p]
        lib.cc_read_batch.restype = ctypes.c_int
        lib.cc_read_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,
        ]
        lib.cc_close.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib


class ClipCacheWriter:
    """Appends clips to `path + '.tmp'`; `finish` writes the index, the
    `.keys.json` beside the shard, and renames the shard into place, so a
    crash mid-populate never leaves a partial shard at `path`."""

    def __init__(self, path: str):
        self.lib = _load_library()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self.tmp_path = path + ".tmp"
        self.handle = self.lib.cc_writer_open(self.tmp_path.encode())
        if not self.handle:
            raise IOError(f"cannot open {self.tmp_path} for writing")
        self.keys: Dict[str, int] = {}

    def add(self, key: str, clip: np.ndarray, label: int) -> int:
        clip = np.ascontiguousarray(clip, np.uint8)
        t, h, w, c = clip.shape
        idx = self.lib.cc_writer_add(self.handle, clip.ctypes.data_as(ctypes.c_char_p), t, h, w, c, label)
        if idx < 0:
            raise IOError("clip cache write failed")
        self.keys[key] = idx
        return idx

    def finish(self) -> str:
        if self.lib.cc_writer_finish(self.handle) != 0:
            raise IOError("clip cache finalize failed")
        self.handle = None
        with open(self.path + ".keys.json", "w") as f:
            json.dump(self.keys, f)
        os.replace(self.tmp_path, self.path)
        return self.path


class ClipCacheReader:
    """A finished shard: `read(i)` one clip, `read_batch(indices)` clips of
    one shape by threaded pread."""

    def __init__(self, path: str):
        self.lib = _load_library()
        self.handle = self.lib.cc_open(path.encode())
        if not self.handle:
            raise IOError(f"cannot open clip cache {path}")
        self.path = path
        keys_path = path + ".keys.json"
        self.keys: Dict[str, int] = {}
        if os.path.exists(keys_path):
            with open(keys_path) as f:
                self.keys = json.load(f)

    def __len__(self) -> int:
        return int(self.lib.cc_num_clips(self.handle))

    def shape(self, idx: int) -> Tuple[Tuple[int, int, int, int], int]:
        out = (ctypes.c_uint32 * 6)()
        if self.lib.cc_clip_shape(self.handle, idx, out) != 0:
            raise IndexError(idx)
        return (out[0], out[1], out[2], out[3]), int(np.uint32(out[4]).view(np.int32))

    def read(self, idx: int) -> Tuple[np.ndarray, int]:
        shape, label = self.shape(idx)
        buf = np.empty(shape, np.uint8)
        if self.lib.cc_read_clip(self.handle, idx, buf.ctypes.data_as(ctypes.c_char_p)) != 0:
            raise IOError(f"read failed for clip {idx}")
        return buf, label

    def read_batch(self, indices: Sequence[int], num_threads: int = 8) -> Tuple[np.ndarray, np.ndarray]:
        """Clips of one shape → ((N, T, H, W, C) uint8, (N,) int32 labels),
        read by `num_threads` threads in C++."""
        indices = np.ascontiguousarray(indices, np.int64)
        shape, _ = self.shape(int(indices[0]))
        stride = int(np.prod(shape))
        out = np.empty((len(indices),) + shape, np.uint8)
        rc = self.lib.cc_read_batch(
            self.handle,
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(indices),
            out.ctypes.data_as(ctypes.c_char_p),
            stride,
            num_threads,
        )
        if rc != 0:
            raise IOError("batched clip read failed")
        labels = np.asarray([self.shape(int(i))[1] for i in indices], np.int32)
        return out, labels

    def close(self):
        if self.handle:
            self.lib.cc_close(self.handle)
            self.handle = None


def cache_path_for(df_key: str, cache_dir: str) -> str:
    digest = hashlib.sha1(df_key.encode()).hexdigest()[:16]
    return os.path.join(cache_dir, f"clips_{digest}.ccache")


class CachingClipSource:
    """Wraps a ClipSource: until the shard is finished, rows are decoded;
    `populate` decodes every row once into the shard; once it is, reads come
    from it.  A shard whose clip count differs from the table's is stale:
    it is deleted and rebuilt by the next `populate`."""

    def __init__(self, source, df: ClipTable, cache_file: str, num_threads: int = 8):
        self.source = source
        self.df = df
        self.cache_file = cache_file
        self.num_threads = num_threads
        self.reader: Optional[ClipCacheReader] = None
        if os.path.exists(cache_file):
            try:
                reader = ClipCacheReader(cache_file)
            except IOError:
                reader = None
            if reader is not None and len(reader) != len(self.df):
                reader.close()
                os.remove(cache_file)
                reader = None
            self.reader = reader

    @property
    def ready(self) -> bool:
        return self.reader is not None

    def populate(self) -> None:
        if self.ready:
            return
        writer = ClipCacheWriter(self.cache_file)
        for row in self.df.rows():
            sample = self.source(row)
            writer.add(str(row.name), sample["rgb"], int(sample["label"]))
        writer.finish()
        self.reader = ClipCacheReader(self.cache_file)

    def __call__(self, row) -> Dict[str, np.ndarray]:
        if not self.ready:
            return self.source(row)
        clip, label = self.reader.read(int(row.name))
        return {"rgb": clip, "label": np.int32(label)}

    def read_batch(self, indices) -> Tuple[np.ndarray, np.ndarray]:
        if not self.ready:
            raise RuntimeError("the clip cache is not populated")
        return self.reader.read_batch(indices, self.num_threads)

"""Build the package's CUDA sources into one shared library and load it.

`csrc/*.cu` expose a plain C interface, so they compile with `nvcc` alone,
without PyTorch's headers, in seconds: one `nvcc -c` per source, all
started together, then one link (`csrc/*.cuh` are included by them; a
kernel with several heavy template instances puts each in a source of its
own, so that they compile side by side).  The library lands in
`<repo>/build/kernels/`, named by a hash of the sources and flags: a changed
source rebuilds, an unchanged one loads the library already built.  Nothing
is built when this module is imported; the first kernel launch builds.
Any failure to find `nvcc`, compile or load raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
# C signature of every exported launcher: (argtypes, restype); each returns
# the launch's cudaError_t.
SIGNATURES = {
    "maxpool3x3x3_same": ([_P, _P, *[_I64] * 5, *[ctypes.c_int] * 5, _P], ctypes.c_int),
    "maxpool3x3x3_same_backward": ([_P, _P, _P, *[_I64] * 5, *[ctypes.c_int] * 6, _P], ctypes.c_int),
    "salt_pepper_f32": (
        [_P, _P, _P, _P, _I64, _I64, ctypes.c_uint64, ctypes.c_uint32, _P],
        ctypes.c_int,
    ),
    "stem_conv_s2d_f32": ([_P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _P], ctypes.c_int),
    "stem_conv_s2d_bf16": ([_P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _P], ctypes.c_int),
    "stem_conv_s2d_bf16_config": (
        [_I64, _I64, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)],
        ctypes.c_int,
    ),
    "int8_conv3d": ([*[_P] * 6, *[_I64] * 11, *[ctypes.c_int] * 14, _P], ctypes.c_int),
    "quantize_int8": ([_P, _P, _P, _I64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P], ctypes.c_int),
}


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME or put nvcc on PATH")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def library_path() -> Path:
    """Where the library for the current sources, headers and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):  # *.cu and *.cuh
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcsec_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the sources unless the library for them exists.  Returns the
    library path and the seconds spent compiling and linking (0.0 when it
    existed)."""
    lib = library_path()
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in _sources()]
        compiles = [
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)] for obj, src in zip(objs, _sources())
        ]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for cmd in compiles]
        outputs = [proc.communicate() for proc in procs]  # wait for every compile
        for cmd, proc, (out, err) in zip(compiles, procs, outputs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}{err}")
        so = str(Path(tmp) / "lib.so")
        link = [nvcc, "-shared", "-o", so, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(link)}\n{proc.stdout}{proc.stderr}")
        os.replace(so, lib)  # atomic: a concurrent build never loads a partial file
    return lib, time.perf_counter() - t0


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare every signature."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check_launch(name: str, err: int) -> None:
    """Raise when a launcher reported a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {err}")

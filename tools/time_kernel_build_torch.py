#!/usr/bin/env python3
"""Time the two ways to build the port's CUDA sources into one library.

    python3 tools/time_kernel_build_torch.py [--repeats 2]

`ops/kernels/_build.py` compiles each `csrc/*.cu` in its own `nvcc -c`,
all started together, then links them.  This script times that form
against one `nvcc -shared` call over every source, in a fresh temporary
directory each time, alternating the two (single, parallel, parallel,
single, ...) so a warm file cache favours neither.  Needs `nvcc` (a CUDA
toolkit), not a card; prints the seconds of every build.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels._build import (  # noqa: E402
    NVCC_FLAGS,
    _nvcc,
    _sources,
)


def single(nvcc: str, out: Path) -> None:
    subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(out / "lib.so"), *map(str, _sources())],
                   check=True, capture_output=True)


def parallel(nvcc: str, out: Path) -> None:
    objs = [str(out / f"{src.stem}.o") for src in _sources()]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)])
             for obj, src in zip(objs, _sources())]
    if any(p.wait() for p in procs):
        raise RuntimeError("nvcc -c failed")
    subprocess.run([nvcc, "-shared", "-o", str(out / "lib.so"), *objs], check=True, capture_output=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeats", type=int, default=2)
    args = parser.parse_args()
    nvcc = _nvcc()
    print(f"{len(_sources())} sources: {', '.join(s.name for s in _sources())}")
    times = {"single": [], "parallel": []}
    order = ["single", "parallel", "parallel", "single"] * args.repeats
    for form in order[: 2 * args.repeats]:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            (single if form == "single" else parallel)(nvcc, Path(tmp))
            times[form].append(time.perf_counter() - t0)
    for form, secs in times.items():
        print(f"{form}: " + ", ".join(f"{s:.2f} s" for s in secs))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the benchmark of the PyTorch/CUDA port on one CUDA card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the checks on standard error and the result as one JSON line last
on standard output (`benchmark/harness.py`)."""

import os
import sys
import time


def _process_start() -> float:
    """perf_counter() of the moment this process started (Linux), so that
    set-up counts the interpreter's start too."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            started = int(f.read().rsplit(")", 1)[1].split()[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(uptime - started, 0.0)
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))

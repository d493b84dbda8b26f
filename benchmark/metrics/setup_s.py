"""Process start to the first timed step: imports, weights and inputs, the program's state, warm-up (and, in a checkout's first run, the kernels' build)."""

from benchmark import readers

UNIT = "s"


def read(run):
    return run.setup_s

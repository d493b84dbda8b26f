"""FLOPs of the window's training clips (3x the forward) over the window times the bf16 peak."""

from benchmark import readers

UNIT = "%"


def read(run):
    return readers.mfu(run, "steps")

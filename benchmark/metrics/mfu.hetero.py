"""FLOPs of the heterogeneous clips answered in the window (published architectures) over the window times the bf16 peak."""

from benchmark import readers

UNIT = "%"


def read(run):
    return readers.mfu(run, "batches")

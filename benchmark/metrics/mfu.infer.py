"""FLOPs of the clips answered in the window (published architectures) over the window times the peak of the convs' precision."""

from benchmark import readers

UNIT = "%"


def read(run):
    return readers.mfu(run, "batches")

"""Device ms a step under the members' ranges (their convs, BatchNorms, pools, kernels)."""

from benchmark import readers

UNIT = "ms"


def read(run):
    return readers.members_ms(run, "batches")

"""Device ms a heterogeneous step under the members' ranges (every family's convs, BatchNorms, pools, kernels)."""

from benchmark import readers

UNIT = "ms"


def read(run):
    return readers.members_ms(run, "batches")

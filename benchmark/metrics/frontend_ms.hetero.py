"""Device ms a heterogeneous step under the front end's ranges (the shared s2d stagings)."""

from benchmark import readers

UNIT = "ms"


def read(run):
    return readers.frontend_ms(run, "batches")

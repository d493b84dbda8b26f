"""Device ms a step under the front end's ranges (decode, augment, noise, s2d staging)."""

from benchmark import readers

UNIT = "ms"


def read(run):
    return readers.frontend_ms(run, "batches")

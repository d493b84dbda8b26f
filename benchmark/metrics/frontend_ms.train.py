"""Device ms a step under the front end's ranges (gather, preprocess: augment, noise, scale)."""

from benchmark import readers

UNIT = "ms"


def read(run):
    return readers.frontend_ms(run, "steps")

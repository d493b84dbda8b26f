"""Device ms a step outside the front end's and the optimizer's ranges: the member's forward and backward."""

from benchmark import readers

UNIT = "ms"


def read(run):
    return readers.members_ms(run, "steps")

"""Host ms a training step call, over all the window's calls (the benchmark's span, nothing synchronised inside)."""

from benchmark import readers

UNIT = "ms"


def read(run):
    return readers.host_ms(run, "steps")

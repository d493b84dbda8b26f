"""Share of the traced window in which no kernel, memcpy or memset ran on the card."""

from benchmark import readers

UNIT = "%"


def read(run):
    return readers.idle_pct(run, "batches")

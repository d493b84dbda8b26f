"""Bound of the 3x3x3/1 max pool's gradient (input, output gradient, input gradient once each, at 3.35 TB/s) over its kernel's device time, summed over the window."""

from benchmark import readers

UNIT = "%"


def read(run):
    return readers.pool_roofline_pct(run, "steps", backward=True)

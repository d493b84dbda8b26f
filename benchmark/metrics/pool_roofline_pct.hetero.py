"""Bound of the 3x3x3/1 max pool (bytes in once, out once, at 3.35 TB/s) over its kernel's device time in the I3D and TwoStream trunks, summed over the window."""

from benchmark import readers

UNIT = "%"


def read(run):
    return readers.pool_roofline_pct(run, "batches", backward=False)

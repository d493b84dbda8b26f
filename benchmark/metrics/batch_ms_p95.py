"""95th percentile, over all batches answered in the window, of the time from a batch's issue to its probabilities in host memory."""

from benchmark import readers

UNIT = "ms"


def read(run):
    return readers.batch_ms_p95(run)

"""Clips whose probabilities and fused predictions reached host memory in the window, over the window's seconds."""

from benchmark import readers

UNIT = "clips/s"


def read(run):
    return readers.infer_clips_per_s(run)

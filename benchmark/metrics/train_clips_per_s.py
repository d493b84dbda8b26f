"""Clips of all optimizer steps in the window, over the window's seconds (the window ends in a synchronize)."""

from benchmark import readers

UNIT = "clips/s"


def read(run):
    return readers.train_clips_per_s(run)

"""The whole step's share of the card's peak FLOP rate (train cells)."""

from benchmark.metrics._common import mfu


def read(r):
    return mfu(r, "train")

"""The whole step's share of the card's peak FLOP rate (sim cells)."""

from benchmark.metrics._common import mfu


def read(r):
    return mfu(r, "sim")

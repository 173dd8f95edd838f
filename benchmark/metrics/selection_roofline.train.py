"""The selection kernels' share of their roofline (train cells)."""

from benchmark.metrics._common import selection_roofline


def read(r):
    return selection_roofline(r, "train")

"""The selection kernels' share of their roofline (sim cells)."""

from benchmark.metrics._common import selection_roofline


def read(r):
    return selection_roofline(r, "sim")

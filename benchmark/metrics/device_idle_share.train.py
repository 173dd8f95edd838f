"""Share of the profiled slice in which the card ran nothing (train cells)."""

from benchmark.metrics._common import idle_share


def read(r):
    return idle_share(r, "train")

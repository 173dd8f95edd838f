"""Host milliseconds a frame in the feature pass (inclusive host time of
the ``frame.features`` span, K2 and its exactness reads inside), over the
traced slice (sim cells).  Taken under the profiler: a split of the
frame, not its time (``_spans.py``)."""

from benchmark.metrics._spans import host


def read(r):
    v = host(r, "sim", "frame.features")
    return None if v is None else 1e3 * v

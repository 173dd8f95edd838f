"""Host milliseconds a frame in the model call (inclusive host time of the
``frame.model`` span), over the traced slice (sim cells).  Taken under
the profiler: a split of the frame, not its time (``_spans.py``)."""

from benchmark.metrics._spans import host


def read(r):
    v = host(r, "sim", "frame.model")
    return None if v is None else 1e3 * v

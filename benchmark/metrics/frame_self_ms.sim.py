"""Host milliseconds a frame in the frame loop itself (self host time of
the ``frame`` span: integration, waypoints, retirement, teleport-in;
the feature pass, the model and the contact counts left out), over the
traced slice (sim cells).  Taken under the profiler: a split of the
frame, not its time (``_spans.py``)."""

from benchmark.metrics._spans import host


def read(r):
    v = host(r, "sim", "frame", "self_s")
    return None if v is None else 1e3 * v

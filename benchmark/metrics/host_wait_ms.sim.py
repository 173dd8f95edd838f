"""Host milliseconds a frame in blocking device-to-host reads (inclusive
host time of the ``sync.*`` spans; 0.0 where the frame makes none), over
the traced slice (sim cells).  Taken under the profiler (``_spans.py``):
the wait for the card to reach the read, plus the read."""

from benchmark.metrics._spans import host_prefix


def read(r):
    v = host_prefix(r, "sim", "sync.")
    return None if v is None else 1e3 * v

"""Stream milliseconds a scored frame in the Sinkhorn OT (CUDA events
around the ``scores.ot`` spans of ``metrics/metrics.py``
``ot_with_time_mask``: one a live frame's banded Sinkhorn, fallback
included), over the traced slice (sim cells; None off a card, and where
the program opens no such span).  The card's time on the OT where it runs
behind the host, the host's enqueue time where it does not
(``_spans.py``)."""

from benchmark.metrics._spans import stream_prefix


def read(r):
    v = stream_prefix(r, "sim", "scores.ot")
    return None if v is None else 1e3 * v

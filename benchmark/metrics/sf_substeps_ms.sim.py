"""Stream milliseconds a frame in the social-force generator's sub-steps
(CUDA events around the ``sf.substeps`` spans of ``gen/socialforce.py``
``simulate``), over the traced slice (sim cells; None off a card, and
where the program opens no such span).  The card's time on the sub-steps
where it runs behind the host, the host's enqueue time where it does not
(``_spans.py``)."""

from benchmark.metrics._spans import stream_prefix


def read(r):
    v = stream_prefix(r, "sim", "sf.substeps")
    return None if v is None else 1e3 * v

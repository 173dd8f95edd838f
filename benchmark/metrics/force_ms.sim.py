"""Stream milliseconds a frame in the force law (CUDA events around the
``mlapm.force`` spans of ``models/mlapm.py`` ``mlapm_force``), over the
traced slice (sim cells; None off a card, and where the program opens no
such span).  The card's time on the law where it runs behind the host,
the host's enqueue time where it does not (``_spans.py``)."""

from benchmark.metrics._spans import stream_prefix


def read(r):
    v = stream_prefix(r, "sim", "mlapm.force")
    return None if v is None else 1e3 * v

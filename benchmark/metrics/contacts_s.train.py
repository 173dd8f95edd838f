"""Stream seconds a step in the contact counts (CUDA events around the
``contacts.frame`` spans, the checkpoint's recompute included, and the
``contacts.labels`` spans), over the traced slice (train cells; None off
a card).  The card's time on the counts where it runs behind the host,
the host's enqueue time where it does not (``_spans.py``)."""

from benchmark.metrics._spans import stream_prefix


def read(r):
    return stream_prefix(r, "train", "contacts.")

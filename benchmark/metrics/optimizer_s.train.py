"""Stream seconds a step in Adam's step (CUDA events around the
``optimizer`` span that ``train.trainer.make_optimizer``'s step hooks
open), over the traced slice (train cells; None off a card).  The card's
time on the step where it runs behind the host, the host's enqueue time
where it does not (``_spans.py``)."""

from benchmark.metrics._spans import stream_prefix


def read(r):
    return stream_prefix(r, "train", "optimizer")

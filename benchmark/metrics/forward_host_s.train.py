"""Host seconds a step in the training loss's forward (inclusive host
time of the ``step.loss`` span: the BPTT rollout and the loss terms),
over the traced slice (train cells).  Taken under the profiler: a split
of the step, not its time (``_spans.py``)."""

from benchmark.metrics._spans import host


def read(r):
    return host(r, "train", "step.loss")

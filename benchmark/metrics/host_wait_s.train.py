"""Host seconds a step in blocking device-to-host reads of the program
(inclusive host time of the ``sync.*`` spans, the checkpoint's
recompute included; 0.0 where the step makes none), over the traced
slice (train cells).  Taken under the profiler (``_spans.py``): the wait
for the card to reach the read, plus the read."""

from benchmark.metrics._spans import host_prefix


def read(r):
    return host_prefix(r, "train", "sync.")

"""Tracing / profiling helpers.

Counterpart of ``piml_tpu/utils/profiling.py``.  The reference only prints
wall-clock deltas (simulators.py:294,361,374).  Here training and rollout
steps can be wrapped in named ``torch.profiler`` ranges and a steps/sec
reporter; ``trace_to`` writes a Chrome trace for Perfetto or
``chrome://tracing``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named range in the trace (``torch.profiler.record_function``; cheap
    when no profiler is running)."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def trace_to(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block: the CPU, and CUDA when a card is present, with a
    Chrome trace written to ``logdir/trace.json`` at the end.  Yields the
    profiler (``key_averages()`` and the rest)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class Throughput:
    """Steps/sec + items/sec counter with periodic reporting."""

    def __init__(self, report_every: int = 50, logger=None):
        self.report_every = report_every
        self.logger = logger
        self._t0: Optional[float] = None
        self._steps = 0
        self._items = 0

    def step(self, items: int = 1) -> Optional[float]:
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
            return None
        self._steps += 1
        self._items += items
        if self._steps % self.report_every == 0:
            dt = now - self._t0
            rate = self._steps / dt
            item_rate = self._items / dt
            if self.logger is not None:
                self.logger.log(steps_per_sec=rate, items_per_sec=item_rate)
            return rate
        return None

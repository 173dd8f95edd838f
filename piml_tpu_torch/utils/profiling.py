"""The program's spans, on the profiler's clock.

Counterpart of ``piml_tpu/utils/profiling.py``.  The reference only prints
wall-clock deltas (simulators.py:294,361,374).

:func:`annotate` is the program's span.  It is on only while a
``torch.profiler`` session is active in the process (any thread): then it
opens a ``torch.profiler.record_function`` range, so the span lies in the
profiler's timeline and Chrome trace beside the card's kernels, and keeps
an in-memory record (name, start and end on the wall clock in ns, the
parent span on the same thread, a trace id shared by every span under one
root; with ``device=True`` also a pair of CUDA events on the current
stream).  Off, it reads one flag, branches and opens nothing.

The record holds the latest stretch of profiled execution: the first
span that opens under a profiler after one that opened without one
clears it, and :func:`reset` clears it explicitly.  :func:`summary` reads
it per span name (count, host seconds inclusive and self, stream
seconds); :func:`spans` returns the raw records.  :func:`trace_to`
profiles a block and writes ``trace.json``, ``spans.json`` and
``idle_gaps.json`` (the card's longest idle gaps, each named by the
program span and the aten op open on the host at its start).

Host times taken under the profiler carry its cost per operator, so they
split a frame or a step between its parts rather than time it.  A device
span's stream seconds are the card's time on the span's work where the
card runs behind the host, and the host's enqueue time where it does not.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _profiler

_RECORDS: List[dict] = []
_LIVE = [False]             # the last span opened under a profiler
_IDS = itertools.count()
_LOCK = threading.Lock()
_LOCAL = threading.local()  # ``stack``: this thread's open spans


def annotate(name: str, device: bool = False):
    """``with annotate(name[, device=True]):`` — a span around the body.
    Without a profiler it returns a shared span that opens nothing: the
    cost is this call, one flag read and a branch."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


class _Off:
    """The span without a profiler."""

    __slots__ = ()

    def __enter__(self):
        if _LIVE[0]:
            _LIVE[0] = False
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    """A span under a profiler: a ``record_function`` range and a record."""

    __slots__ = ("name", "device", "_rec", "_range", "_ev")

    def __init__(self, name: str, device: bool):
        self.name = name
        self.device = device

    def __enter__(self):
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        parent = stack[-1] if stack else None
        rec = {"id": next(_IDS), "name": self.name,
               "parent": parent["id"] if parent else None,
               "trace_id": None, "thread": threading.get_ident(),
               "start_ns": 0, "end_ns": None}
        rec["trace_id"] = parent["trace_id"] if parent else rec["id"]
        with _LOCK:
            if not _LIVE[0]:
                _RECORDS.clear()
                _LIVE[0] = True
            _RECORDS.append(rec)
        stack.append(rec)
        self._rec = rec
        self._ev = None
        if self.device and torch.cuda.is_initialized():
            self._ev = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            self._ev[0].record()
        self._range = torch.profiler.record_function(self.name)
        rec["start_ns"] = time.time_ns()
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        rec = self._rec
        self._range.__exit__(None, None, None)
        if self._ev is not None:
            self._ev[1].record()
            rec["events"] = self._ev
        rec["end_ns"] = time.time_ns()
        stack = _LOCAL.stack
        if stack and stack[-1] is rec:
            stack.pop()
        elif rec in stack:
            stack.remove(rec)
        return False


class StepSpan:
    """A span around ``torch.optim.Optimizer.step``, opened and closed by
    the optimizer's step pre- and post-hooks:
    ``opt.register_step_pre_hook(s.pre)``,
    ``opt.register_step_post_hook(s.post)``."""

    __slots__ = ("name", "device", "_span")

    def __init__(self, name: str, device: bool = False):
        self.name = name
        self.device = device
        self._span = None

    def pre(self, optimizer, args, kwargs):
        if self._span is not None:  # a step that raised left it open
            self._span.__exit__(None, None, None)
        span = annotate(self.name, self.device)
        span.__enter__()
        self._span = span if span is not _OFF else None

    def post(self, optimizer, args, kwargs):
        if self._span is not None:
            self._span.__exit__(None, None, None)
            self._span = None


def reset() -> None:
    """Clear the record."""
    with _LOCK:
        _RECORDS.clear()


def _stream_s(rec: dict) -> Optional[float]:
    ev = rec.get("events")
    if ev is None:
        return None
    ev[1].synchronize()
    return ev[0].elapsed_time(ev[1]) * 1e-3


def spans() -> List[dict]:
    """The record's closed spans, in the order they opened: ``id``,
    ``name``, ``parent`` (an id or None), ``trace_id``, ``thread``,
    ``start_ns``, ``end_ns`` (wall clock, ``time.time_ns``) and, for
    device spans on a card, ``stream_s``."""
    out = []
    for rec in list(_RECORDS):
        if rec["end_ns"] is None:
            continue
        row = {k: v for k, v in rec.items() if k != "events"}
        if "events" in rec:
            row["stream_s"] = _stream_s(rec)
        out.append(row)
    return out


def summary() -> Dict[str, dict]:
    """Per span name: ``count``, ``host_s`` (inclusive), ``self_s``
    (inclusive less what child spans cover) and ``stream_s`` (the device
    spans' CUDA-event seconds; None where the name has none)."""
    recs = spans()
    child: Dict[int, int] = {}
    for r in recs:
        if r["parent"] is not None:
            child[r["parent"]] = (child.get(r["parent"], 0)
                                  + r["end_ns"] - r["start_ns"])
    out: Dict[str, dict] = {}
    for r in recs:
        s = out.setdefault(r["name"], {"count": 0, "host_s": 0.0,
                                       "self_s": 0.0, "stream_s": None})
        dur = r["end_ns"] - r["start_ns"]
        s["count"] += 1
        s["host_s"] += dur * 1e-9
        s["self_s"] += (dur - child.get(r["id"], 0)) * 1e-9
        if r.get("stream_s") is not None:
            s["stream_s"] = (s["stream_s"] or 0.0) + r["stream_s"]
    return out


def idle_gaps(prof, names) -> List[dict]:
    """The 20 longest gaps between the card's operations in a
    finished profile (the union of its CUDA events, annotations left
    out), each named by the innermost span of ``names`` and the innermost
    ``aten::`` op open on the host at the gap's start.  Times in µs from
    the profile's start."""
    from torch.autograd import DeviceType

    dev, marks, ops = [], [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                dev.append((tr.start, tr.end))
        elif e.name in names:
            marks.append((tr.start, tr.end, e.name))
        elif e.name.startswith("aten::"):
            ops.append((tr.start, tr.end, e.name))
    gaps, end = [], None
    for s, e in sorted(dev):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)

    def inner(rows, t):
        hit = min((r for r in rows if r[0] <= t < r[1]),
                  key=lambda r: r[1] - r[0], default=None)
        return hit[2] if hit else None

    gaps.sort(key=lambda g: g[0] - g[1])
    return [{"start_us": s, "gap_ms": (e - s) * 1e-3,
             "span": inner(marks, s), "op": inner(ops, s)}
            for s, e in gaps[:20]]


def _write(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


@contextlib.contextmanager
def trace_to(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block: the CPU, and CUDA when a card is present.
    Writes ``logdir/trace.json`` (the Chrome trace, for Perfetto or
    ``chrome://tracing``), ``spans.json`` (the block's spans) and
    ``idle_gaps.json`` (:func:`idle_gaps`: why the card sat idle).
    Yields the profiler (``key_averages()`` and the rest)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    reset()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    recs = spans()
    _write(os.path.join(logdir, "spans.json"), recs)
    _write(os.path.join(logdir, "idle_gaps.json"),
           idle_gaps(prof, {r["name"] for r in recs}))

"""Arithmetic of the readers of the program's spans
(``piml_tpu_torch.utils.profiling``), read after the traced slice.

Each span's time is taken under the profiler, so host times carry its
cost per operator: they split a frame or a step between its parts, as
the idle shares do, and do not time it.  A device span's stream time
(CUDA events around it) is the card's time on the span's work where the
card runs behind the host, and the host's enqueue time where it does
not.  A reader returns None where the program keeps no such record (a
program without spans), where the slice recorded no ``frame`` (sim) or
``step.loss`` (train) span, and, for stream times, off a card."""

from __future__ import annotations

# the span that marks a unit of each kind of cell
MARK = {"sim": "frame", "train": "step.loss"}


def _record(r, kind: str):
    """The slice's span summary and its frames or steps, or None."""
    sl = getattr(r, "slice", None)
    if r.kind != kind or not sl:
        return None
    units = sl["frames"] if kind == "sim" else sl["steps"]
    if not units:
        return None
    from piml_tpu_torch.utils import profiling

    summary = getattr(profiling, "summary", None)  # a program without spans
    if summary is None:
        return None
    spans = summary()
    if MARK[kind] not in spans:
        return None
    return spans, units


def host(r, kind: str, name: str, field: str = "host_s"):
    """Host seconds of span ``name`` per frame or step (``self_s``: less
    its child spans); 0.0 where the slice opened none."""
    got = _record(r, kind)
    if got is None:
        return None
    spans, units = got
    return spans.get(name, {}).get(field, 0.0) / units


def host_prefix(r, kind: str, prefix: str):
    """Inclusive host seconds of the spans named ``prefix*`` per frame or
    step; 0.0 where the slice opened none."""
    got = _record(r, kind)
    if got is None:
        return None
    spans, units = got
    return sum(s["host_s"] for n, s in spans.items()
               if n.startswith(prefix)) / units


def stream_prefix(r, kind: str, prefix: str):
    """Stream seconds of the device spans named ``prefix*`` per step;
    None off a card or where none recorded CUDA events."""
    got = _record(r, kind)
    if got is None:
        return None
    spans, units = got
    times = [s["stream_s"] for n, s in spans.items()
             if n.startswith(prefix) and s["stream_s"] is not None]
    if not times:
        return None
    return sum(times) / units

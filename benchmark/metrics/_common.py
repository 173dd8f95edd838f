"""Arithmetic the per-layer readers share.  Each reader returns None where
its run has nothing to read; a share of a peak is never made up as 0."""

from __future__ import annotations


def idle_share(r, kind: str):
    """100 · (1 − device busy ÷ wall) over the profiled slice."""
    sl = getattr(r, "slice", None)
    if r.kind != kind or not sl or sl["wall_s"] <= 0 or sl["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["wall_s"])


def mfu(r, kind: str):
    """100 · model FLOPs of the window ÷ its wall time ÷ the card's peak of
    the configuration's compute dtype."""
    if r.kind != kind or not r.compute_peak or not r.flops or r.window_s <= 0:
        return None
    return 100.0 * r.flops / r.window_s / r.compute_peak


def selection_roofline(r, kind: str):
    """100 · least time of every selection pass the slice's frames need
    (agents and obstacles, each frame and channel, whatever route the
    program takes) ÷ device time of the slice's kernels named ``*topk*``.
    A pass that the program takes in plain operations adds to the first
    and not to the second; none where no such kernel ran."""
    sl = getattr(r, "slice", None)
    if r.kind != kind or not sl or not r.least_selection_s:
        return None
    topk = sum(s for name, s in sl["kernel_s"].items() if "topk" in name)
    if topk <= 0:
        return None
    return 100.0 * r.least_selection_s / topk

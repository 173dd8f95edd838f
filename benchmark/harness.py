"""The benchmark's engine: find a cell's files by name, run its driver's
set-up, the measured window and the traced slice, read the metrics and
decide ``correct``.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own under ``benchmark/``: ``configs/<config>.json``,
``traffic/<mix>.json`` (which names its driver), ``drivers/<driver>.py``,
``metrics/<metric>.py`` and ``limits/<cell>.json``.  A new cell of an
existing driver is data alone.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import statistics
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from benchmark.yardstick import compare, peaks as peaks_mod

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "piml_tpu")


def read_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(BENCH, kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with its configuration, traffic, limits
    and the metric entries of ``BENCHMARK.json`` that it reports."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, dict]
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(name: str, bench: Optional[dict] = None,
              traffic_override: Optional[dict] = None) -> Cell:
    bench = bench or read_json(os.path.join(ROOT, "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = read_json(os.path.join(ROOT, cfg_entry["file"]))
    traffic = read_json(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
    traffic.update(traffic_override or {})
    limits = read_json(os.path.join(BENCH, "limits", name + ".json"))["limits"]

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    per_layer = [m for m in bench["per_layer"] if mine(m)]
    e2e = [m for m in bench["end_to_end"] if mine(m)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in per_layer if m["moves"] in moved]
    return Cell(name, w["chips"], config, traffic, limits, e2e, per_layer)


class Device:
    """The card, or (in the CPU tests) the host: synchronisation and the
    memory high-water mark."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def reset_peak(self):
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.cuda else 0

    def event(self):
        return torch.cuda.Event(enable_timing=True) if self.cuda else None

    def describe(self) -> dict:
        if not self.cuda:
            return {"platform": "cpu", "kind": "cpu", "count": 1}
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(self.device),
                "count": 1}


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell's data, the seed and the device."""

    cell: Cell
    seed: int
    device: torch.device
    dev: Device

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"


# ---------------------------------------------------------------------------
# the traced slice
# ---------------------------------------------------------------------------

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx", "cudaGraphLaunch")


def _union(intervals):
    total, gaps, end = 0.0, [], None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total, gaps


def reduce_trace(prof, wall_s: float) -> dict:
    """Busy seconds (the union of device operations), seconds by kernel
    name, runtime launch calls, the longest device-idle gaps named by the
    innermost host operation running at their start."""
    from torch.autograd import DeviceType

    dev_iv, cpu = [], []
    by_name: Dict[str, float] = {}
    launches = 0
    for e in prof.events():
        tr = e.time_range
        if getattr(e, "is_user_annotation", False):
            continue
        if e.device_type == DeviceType.CUDA:
            dev_iv.append((tr.start, tr.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + (tr.end - tr.start) * 1e-6
        else:
            cpu.append((tr.start, tr.end, e.name))
            if e.name in LAUNCH_CALLS:
                launches += 1
    busy_us, gaps = _union(dev_iv)
    named = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        inner = min((c for c in cpu if c[0] <= s < c[1]),
                    key=lambda c: c[1] - c[0], default=None)
        named.append([inner[2] if inner else "host", (e - s) * 1e-6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"busy_s": busy_us * 1e-6, "wall_s": wall_s, "kernel_s": by_name,
            "launches": launches,
            "device_ops": [[k[:160], v] for k, v in ops[:10]],
            "idle_gaps": named}


def trace_slice(ctx: Context, sess, units: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if ctx.dev.cuda:
        acts.append(ProfilerActivity.CUDA)
    sess.recording = True
    frames = steps = 0
    with profile(activities=acts) as prof:
        ctx.dev.sync()
        t0 = time.perf_counter()
        for _ in range(units):
            done = sess.unit()
            ctx.dev.sync()
            frames += done.get("frames", 0)
            steps += done.get("steps", 0)
        wall = time.perf_counter() - t0
    sess.recording = False
    out = reduce_trace(prof, wall)
    out.update(frames=frames, steps=steps)
    return out


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------

def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def percentile(values: List[float], q: int) -> float:
    """The ``q``-th percentile (``statistics.quantiles``, exclusive)."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=100)[q - 1]


class Readings:
    """What the per-layer readers read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float,
             log: Callable[[str], None] = lambda s: None) -> dict:
    """Set up, measure, trace, check; returns the result line's object."""
    dev = Device(device)
    ctx = Context(cell, seed, device, dev)
    driver = load_module("drivers", cell.traffic["driver"])
    sess = driver.Session(ctx)
    dev.sync()
    setup_s = time.perf_counter() - t_start
    setup_peak = dev.peak()
    log(f"setup_s {setup_s:.3f}")

    dev.reset_peak()
    lat: List[float] = []
    frames = steps = 0
    sess.time_backward = trace
    t0 = time.perf_counter()
    while True:
        u0 = time.perf_counter()
        done = sess.unit()
        dev.sync()
        t = time.perf_counter()
        lat.append(t - u0)
        frames += done.get("frames", 0)
        steps += done.get("steps", 0)
        if t - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    sess.time_backward = False
    peak = dev.peak()
    window_flops = sess.window_flops()
    attempted, failed = len(lat), sess.failed
    counters = sess.counters()
    q = max(1, len(lat) // 4)
    log(f"window_s {window_s:.3f} units {len(lat)}; mean unit ms by quarter "
        + " ".join(f"{1e3 * sum(lat[i:i + q]) / len(lat[i:i + q]):.3f}"
                   for i in range(0, len(lat), q)))
    log("counters " + json.dumps(counters))

    kind = sess.kind
    e2e = {
        "ms_per_frame": window_s * 1e3 / frames if frames else None,
        "episode_ms_p95": (percentile([x * 1e3 for x in lat], 95)
                           if kind == "sim" else None),
        "train_step_s": window_s / steps if steps else None,
        "peak_mem_gib": peak / 2 ** 30 if dev.cuda else None,
        "setup_s": setup_s,
    }
    device_info = dev.describe()
    device_info["memory_peak_bytes"] = max(peak, setup_peak)
    card_peaks = peaks_mod.peaks_for(device_info["kind"]) or {}

    metrics: Dict[str, dict] = {}
    breakdown = None
    if trace:
        sl = trace_slice(ctx, sess, sess.slice_units)
        device_info["busy_s"] = sl["busy_s"]
        device_info["window_s"] = sl["wall_s"]
        breakdown = {"device_ops": sl["device_ops"],
                     "idle_gaps": sl["idle_gaps"]}
        r = Readings(kind=kind, window_s=window_s, flops=window_flops,
                     compute_peak=(peaks_mod.compute_peak(
                         card_peaks, cell.config.get("compute_dtype", "float32"))
                         if card_peaks else None),
                     slice=sl, least_selection_s=(
                         sess.slice_selection_seconds(card_peaks)
                         if card_peaks else None),
                     backward_s=sess.backward_seconds())
        for m in cell.per_layer:
            val = load_module("metrics", m["name"]).read(r)
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            got = e2e.get(m["name"])
            if got is not None:
                metrics[m["name"]] = {"value": got, "unit": m["unit"]}

    numbers = sess.check()
    verdicts = compare.judge(numbers, cell.limits)
    return {
        "correct": all(v["ok"] for v in verdicts),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": device_info,
        **({"breakdown": breakdown} if breakdown else {}),
        "checks": {v["name"]: {"value": v["value"], "limit": v["limit"]}
                   for v in verdicts},
        "_numbers": numbers,
    }

"""CPU tests of the readers of the program's spans (``metrics/_spans.py``
and the eight metrics that use it), at each traffic's tiny size.

    python -m pytest benchmark/tests/test_span_metrics.py -q -p no:cacheprovider

A traced run reports every host-span metric listed for its cell, and no
stream-time metric (no card); a run whose slice ran without the profiler
reports none of them.
"""

from __future__ import annotations

import contextlib
import os
import time

import pytest
import torch

from benchmark import harness

CPU = torch.device("cpu")
HOST = {"features_host_ms.sim", "model_host_ms.sim", "frame_self_ms.sim",
        "host_wait_ms.sim", "forward_host_s.train", "host_wait_s.train"}
DEVICE = {"contacts_s.train", "optimizer_s.train"}
SPANS = HOST | DEVICE


def bench_json():
    return harness.read_json(os.path.join(harness.ROOT, "BENCHMARK.json"))


CELLS = sorted(w["name"] for w in bench_json()["workloads"])


def listed(name):
    """The span metrics that ``BENCHMARK.json`` lists for cell ``name``."""
    return {m["name"] for m in bench_json()["per_layer"]
            if m["name"] in SPANS and name in m["workloads"]}


def tiny_traced_run(name):
    from piml_tpu_torch.utils import profiling

    profiling.reset()
    torch.manual_seed(0)
    cell = harness.load_cell(
        name, traffic_override=harness.load_cell(name).traffic["tests"]["cpu"])
    return harness.run_cell(cell, 2 ** 31 + 91, 0.2, True, CPU,
                            time.perf_counter())


def test_every_span_metric_has_its_entry_and_reader():
    entries = {m["name"]: m for m in bench_json()["per_layer"]}
    assert SPANS <= set(entries)
    for name in SPANS:
        m = entries[name]
        assert m["better"] == "lower"
        assert m["source"] == ("device_trace" if name in DEVICE
                               else "host_clock")
        kind = name.rsplit(".", 1)[1]
        assert all(harness.load_cell(c).traffic["driver"] ==
                   {"sim": "rollout_episodes", "train": "train_steps"}[kind]
                   for c in m["workloads"])
        assert callable(harness.load_module("metrics", name).read)


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_the_host_spans_and_no_stream_time(name):
    res = tiny_traced_run(name)
    assert res["correct"], res["checks"]
    want = listed(name)
    assert want
    got = {k: v["value"] for k, v in res["metrics"].items() if k in SPANS}
    assert set(got) == want & HOST
    for k, v in got.items():
        if k.startswith("host_wait"):
            assert v >= 0.0
        else:
            assert v > 0.0, (k, v)


@pytest.mark.parametrize("name", ["pinnsf_bm.dense_rollout",
                                  "pinnsf_bm.gc_finetune"])
def test_a_slice_without_the_profiler_reports_no_span_metric(monkeypatch,
                                                             name):
    """The slice runs with ``torch.profiler.profile`` replaced by a
    profiler that records nothing and never turns the spans on."""

    class Silent:
        def events(self):
            return []

    @contextlib.contextmanager
    def silent(**kw):
        yield Silent()

    monkeypatch.setattr(torch.profiler, "profile", silent)
    res = tiny_traced_run(name)
    assert res["correct"], res["checks"]
    assert not set(res["metrics"]) & SPANS
    for kind in ("sim", "train"):
        r = harness.Readings(kind=kind, slice={"frames": 10, "steps": 1})
        for metric in SPANS:
            assert harness.load_module("metrics", metric).read(r) is None

"""The port's spans (``piml_tpu_torch/utils/profiling.py``) on the CPU.

A span is on only under ``torch.profiler``; then it records its name,
parent, trace id and wall-clock times, and its ``record_function`` range
lies in the exported trace on the same clock.  The program's spans sit
in the frame loop, the feature pass, the model call, the contact counts,
the loss, the optimizer step and the blocking host reads.
"""

import json
import os
import statistics
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_compare  # noqa: F401  (shares the cores between workers)
from piml_tpu_torch.config import PIMLConfig
from piml_tpu_torch.engine import (EngineConfig, SpawnFrame, batched_rollout,
                                   init_state, rollout)
from piml_tpu_torch.models import ModelSpec, build_model
from piml_tpu_torch.ops import banded
from piml_tpu_torch.utils import profiling
from piml_tpu_torch.utils.profiling import annotate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "repro_work", "gc_sf_repro.npy")
CFG = dict(model="pinnsf_bm", dataset_name="gc2344", dropout=0.0,
           skip_frames=25, time_unit=0.08)


def profiled():
    return profile(activities=[ProfilerActivity.CPU])


def by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r["name"], []).append(r)
    return out


@pytest.fixture(autouse=True)
def clean_record():
    profiling.reset()
    yield
    profiling.reset()


# ---------------------------------------------------------------------------
# the span
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device", [False, True])
def test_span_off_without_a_profiler_records_nothing(device):
    ran = []
    with annotate("off", device=device):
        ran.append(1)
    assert ran == [1]
    assert profiling.spans() == [] and profiling.summary() == {}


def test_spans_record_names_parents_trace_ids_and_self_time():
    with profiled():
        with annotate("root"):
            for _ in range(3):
                with annotate("child"):
                    with annotate("leaf"):
                        torch.ones(32, 32).sum()
            torch.ones(64, 64).sum()
        with annotate("root"):
            pass
    recs = profiling.spans()
    names = by_name(recs)
    assert {k: len(v) for k, v in names.items()} == {"root": 2, "child": 3,
                                                      "leaf": 3}
    ids = {r["id"]: r for r in recs}
    first, second = names["root"]
    assert first["parent"] is None and first["trace_id"] == first["id"]
    assert second["trace_id"] == second["id"] != first["trace_id"]
    for c in names["child"]:
        assert c["parent"] == first["id"]
        assert c["trace_id"] == first["id"]
    for leaf in names["leaf"]:
        assert ids[leaf["parent"]]["name"] == "child"
        assert leaf["trace_id"] == first["id"]
    for r in recs:
        assert r["end_ns"] >= r["start_ns"]
        if r["parent"] is not None:
            p = ids[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] <= p["end_ns"]

    s = profiling.summary()
    assert {k: v["count"] for k, v in s.items()} == {"root": 2, "child": 3,
                                                      "leaf": 3}
    inclusive = {k: sum((r["end_ns"] - r["start_ns"]) for r in v) * 1e-9
                 for k, v in names.items()}
    for k in s:
        assert s[k]["host_s"] == pytest.approx(inclusive[k])
        assert s[k]["stream_s"] is None
    assert s["leaf"]["self_s"] == pytest.approx(s["leaf"]["host_s"])
    assert s["child"]["self_s"] == pytest.approx(
        s["child"]["host_s"] - s["leaf"]["host_s"])
    assert s["root"]["self_s"] == pytest.approx(
        s["root"]["host_s"] - s["child"]["host_s"])
    assert 0 < s["root"]["self_s"] < s["root"]["host_s"]


def test_a_span_on_another_thread_is_a_root_of_its_own():
    """The autograd engine recomputes a checkpointed frame on a thread of
    its own: the span there is kept, as a root, and the flag that turns
    spans on is the process's, not the thread's."""
    with profiled():
        with annotate("main"):
            t = threading.Thread(target=lambda: annotate("worker").__enter__()
                                 .__exit__(None, None, None))
            t.start()
            t.join()
    names = by_name(profiling.spans())
    worker, main = names["worker"][0], names["main"][0]
    assert worker["parent"] is None and worker["trace_id"] == worker["id"]
    assert worker["thread"] != main["thread"]


def test_threads_opening_spans_at_once_lose_none():
    """More threads than cores open nested spans under one profiler with a
    short switch interval: every span is kept once, each nested under its
    own thread's root."""
    import sys

    threads, each = 2 * (os.cpu_count() or 4), 50

    def work():
        with annotate("t.root"):
            for _ in range(each):
                with annotate("t.leaf"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiled():
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    recs = profiling.spans()
    assert len({r["id"] for r in recs}) == len(recs) == threads * (each + 1)
    ids = {r["id"]: r for r in recs}
    for r in recs:
        if r["name"] == "t.leaf":
            root = ids[r["parent"]]
            assert root["name"] == "t.root" and root["thread"] == r["thread"]
            assert r["trace_id"] == root["id"]


def test_a_span_closes_when_its_body_raises():
    with profiled():
        with pytest.raises(ValueError):
            with annotate("raises"):
                raise ValueError("body")
        with annotate("after"):
            pass
    names = by_name(profiling.spans())
    assert names["after"][0]["parent"] is None
    assert names["raises"][0]["end_ns"] is not None


@pytest.mark.parametrize("between", ["unprofiled span", "reset"])
def test_a_new_stretch_of_profiling_clears_the_last(between):
    with profiled():
        with annotate("first"):
            pass
    assert set(profiling.summary()) == {"first"}
    if between == "reset":
        profiling.reset()
        assert profiling.summary() == {}
    else:
        with annotate("unprofiled"):
            pass
        assert set(profiling.summary()) == {"first"}  # kept until then
    with profiled():
        with annotate("second"):
            pass
    assert set(profiling.summary()) == {"second"}


# ---------------------------------------------------------------------------
# the program's spans
# ---------------------------------------------------------------------------

def _model():
    return build_model(ModelSpec.from_config(PIMLConfig(**CFG))).eval()


def _state_and_spawns(n, frames, lead=()):
    g = torch.Generator().manual_seed(3)
    p = torch.rand(lead + (n, 2), generator=g) * 4
    z = torch.zeros(lead + (n, 2))
    state = init_state(p, z, z, z, torch.zeros(lead + (n,), dtype=torch.int32),
                       torch.zeros(lead + (n, 6, 6)),
                       torch.zeros(lead + (n, 10, 6)),
                       torch.zeros(lead + (n, 7)))
    t_axis = (frames,) + lead if not lead else lead + (frames,)
    zt = torch.zeros(t_axis + (n, 2))
    spawns = SpawnFrame(torch.zeros(t_axis + (n,)), zt, zt, zt, zt,
                        torch.zeros(t_axis + (n,), dtype=torch.int32), zt)
    return p, state, spawns


def test_rollout_records_each_frame_its_features_and_model_once():
    n, frames = 30, 4
    p, state, spawns = _state_and_spawns(n, frames)
    with profiled():
        rollout(_model(), EngineConfig(), state, spawns,
                torch.zeros(1, n, 2), torch.ones(n, dtype=torch.int32),
                torch.zeros(4, 2), torch.ones(n, 1))
    recs = profiling.spans()
    s = profiling.summary()
    assert {k: v["count"] for k, v in s.items()} == {
        "rollout": 1, "frame": frames, "frame.features": frames,
        "frame.model": frames}
    ids = {r["id"]: r for r in recs}
    root = by_name(recs)["rollout"][0]
    assert all(r["trace_id"] == root["id"] for r in recs)
    for r in recs:
        want = {"rollout": None, "frame": "rollout", "frame.features": "frame",
                "frame.model": "frame"}[r["name"]]
        got = ids[r["parent"]]["name"] if r["parent"] is not None else None
        assert got == want
    assert s["frame"]["self_s"] < s["frame"]["host_s"]


@pytest.mark.parametrize("remat", [False, True])
def test_batched_rollout_keeps_the_recomputed_frames_spans(remat):
    """Each frame counts its contacts once (soft and hard in one call);
    the checkpoint's recompute under ``backward()`` counts them again.  The
    loss reads the final state's features, so the backward needs every
    frame recomputed through its feature pass, past the contacts (the
    recompute stops early where the backward needs less)."""
    C, n, frames = 2, 24, 3
    p, state, spawns = _state_and_spawns(n, frames, lead=(C,))
    state.p.requires_grad_(True)
    model = _model()
    with profiled():
        final, _ = batched_rollout(
            model, EngineConfig(retire_on_arrival=False,
                                track_collisions=True, remat=remat),
            state, spawns, torch.zeros(1, n, 2),
            torch.ones(n, dtype=torch.int32), torch.zeros(4, 2),
            torch.ones(n, 1))
        final.ped_f.sum().backward()
    s = profiling.summary()
    runs = 2 if remat else 1
    assert s["contacts.frame"]["count"] == frames * runs
    assert s["frame"]["count"] == frames * runs
    assert s["rollout"]["count"] == 1
    assert s["contacts.frame"]["stream_s"] is None  # no card


@pytest.mark.parametrize("batched", [False, True])
def test_k2_blocking_reads_are_spans(batched):
    """One exactness read a call; the cell index's host-to-device copies
    and its ``bincount`` read are spans too (on the card each blocks until
    the card has run what was queued before it)."""
    g = torch.Generator().manual_seed(5)
    shape = (2, 600, 2) if batched else (600, 2)
    pos = torch.rand(shape, generator=g) * 40
    head = torch.nn.functional.normalize(torch.randn(shape, generator=g),
                                         dim=-1)
    with profiled():
        for _ in range(3):
            banded.topk_neighbors_banded_or_dense(pos, head, 6, 90.0,
                                                  lambda: None)
    s = profiling.summary()
    assert s["sync.k2_exact"]["count"] == 3
    # the agents' cell index, built again each call for each channel
    chans = 2 if batched else 1
    for site in ("sync.cell_quantiles", "sync.cell_divisor",
                 "sync.cell_bincount"):
        assert s[site]["count"] == 3 * chans, site


def _tiny_finetune_batch(cfg):
    from piml_tpu_torch.data import make_time_indexed, to_channeled
    from piml_tpu_torch.scene import Scene, codec

    arrays = codec.decode(SCENE)
    for key in ("position", "velocity", "acceleration", "destination",
                "dest_idx", "mask_p", "mask_v", "mask_a"):
        arrays[key] = arrays[key][:40]
    data = make_time_indexed(cfg, Scene.from_arrays(arrays, device="cpu"))
    return to_channeled(data, 5, "slice").slice_channels([5, 6])


def test_training_loss_spans_its_body_and_the_label_contacts():
    from piml_tpu_torch.engine import training_rollout_loss

    cfg = PIMLConfig(**CFG)
    batch = _tiny_finetune_batch(cfg)
    model = build_model(ModelSpec.from_config(cfg))
    with profiled():
        out = training_rollout_loss(model, cfg, batch)
    s = profiling.summary()
    frames = batch.num_frames
    assert s["step.loss"]["count"] == 1
    assert s["contacts.labels"]["count"] == 1
    assert s["contacts.frame"]["count"] == frames
    assert s["frame"]["count"] == frames
    recs = by_name(profiling.spans())
    loss = recs["step.loss"][0]
    assert recs["rollout"][0]["parent"] == loss["id"]
    assert all(r["parent"] == loss["id"] for r in recs["contacts.labels"])
    assert torch.isfinite(out.loss)


@pytest.mark.parametrize("finetune,model", [(False, "pinnsf_bm"),
                                            (True, "pinnsf_bm"),
                                            (True, "pinnsf_res")])
def test_optimizer_step_is_one_span_a_step(finetune, model):
    from piml_tpu_torch.train.trainer import make_optimizer

    cfg = PIMLConfig(**dict(CFG, model=model))
    net = build_model(ModelSpec.from_config(cfg))
    opt = make_optimizer(cfg, net, finetune=finetune)
    params = list(net.parameters())
    for _ in range(2):  # off: no span
        sum(p.sum() for p in params).backward()
        opt.step()
    assert profiling.summary() == {}
    with profiled():
        for _ in range(3):
            opt.zero_grad()
            sum((p ** 2).sum() for p in params).backward()
            opt.step()
    s = profiling.summary()
    assert s["optimizer"]["count"] == 3
    assert s["optimizer"]["host_s"] > 0
    assert s["optimizer"]["stream_s"] is None  # no card


# ---------------------------------------------------------------------------
# trace_to: the Chrome trace, the spans and the idle gaps
# ---------------------------------------------------------------------------

def test_trace_to_writes_spans_and_idle_gaps_on_the_trace_clock(tmp_path):
    logdir = str(tmp_path / "trace")
    with annotate("before"):  # off: not in the trace's record
        pass
    with profiling.trace_to(logdir):
        for i in range(30):
            with annotate(f"span{i}"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(logdir, "trace.json")) as f:
        trace = json.load(f)
    with open(os.path.join(logdir, "spans.json")) as f:
        recs = json.load(f)
    with open(os.path.join(logdir, "idle_gaps.json")) as f:
        gaps = json.load(f)
    assert [r["name"] for r in recs] == [f"span{i}" for i in range(30)]
    assert gaps == []  # no card: no device operation, no gap
    base = trace["baseTimeNanoseconds"]
    events = {e["name"]: e for e in trace["traceEvents"]
              if e.get("cat") == "user_annotation"}
    offsets_us = [(base + events[r["name"]]["ts"] * 1e3 - r["start_ns"]) / 1e3
                  for r in recs]
    assert abs(statistics.median(offsets_us)) < 50.0, offsets_us


def test_idle_gaps_name_each_gap_by_span_and_aten_op():
    """On a profile whose device events are given, the gaps between the
    union of the device operations come out longest first, each named by
    the innermost span and aten op open at its start."""
    from torch.autograd import DeviceType

    class Range:
        def __init__(self, start, end):
            self.start, self.end = start, end

    class Event:
        def __init__(self, name, start, end, device=DeviceType.CPU,
                     annotation=False):
            self.name, self.time_range = name, Range(start, end)
            self.device_type, self.is_user_annotation = device, annotation

    class Prof:
        def events(self):
            cuda = DeviceType.CUDA
            return [Event("frame", 0, 100), Event("frame.features", 40, 90),
                    Event("aten::copy_", 45, 60), Event("aten::add", 0, 5),
                    Event("k", 0, 10, cuda), Event("k", 8, 20, cuda),
                    Event("k", 50, 55, cuda), Event("k", 70, 71, cuda),
                    Event("frame", 20, 95, cuda, annotation=True)]

    gaps = profiling.idle_gaps(Prof(), {"frame", "frame.features"})
    assert [(g["start_us"], g["gap_ms"]) for g in gaps] == [
        (20, pytest.approx(0.030)), (55, pytest.approx(0.015))]
    assert [(g["span"], g["op"]) for g in gaps] == [
        ("frame", None), ("frame.features", "aten::copy_")]

"""CPU tests of the benchmark harness, at tiny sizes.

    python -m pytest benchmark/tests -q -p no:cacheprovider

They check that every cell loads as data, the yardstick's counts on tiny
shapes, that the plain reference meets the program on the CPU, that a run
with its timed path broken reports ``correct`` false, and that nothing here
imports JAX or the JAX package.  The ``card`` test runs the TF32 control
on a card.
"""

from __future__ import annotations

import ast
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness
from benchmark.yardstick import compare, flops, model_layers, selection

BENCH = harness.BENCH
ROOT = harness.ROOT
CPU = torch.device("cpu")


def bench_json():
    return harness.read_json(os.path.join(ROOT, "BENCHMARK.json"))


CELLS = sorted(w["name"] for w in bench_json()["workloads"])


def stand_in(name, where):
    """The cell's traffic's stand-in for the tests: ``cpu`` (tiny) or
    ``card`` (the control test's size)."""
    return harness.load_cell(name).traffic["tests"][where]


def load_faults(driver):
    """``tests/faults/<driver>.py``: the faults planted in that driver's
    timed path."""
    path = os.path.join(BENCH, "tests", "faults", driver + ".py")
    spec = importlib.util.spec_from_file_location(f"_faults_{driver}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tiny_run(name, seconds=0.3, trace=False):
    torch.manual_seed(0)
    cell = harness.load_cell(name, traffic_override=stand_in(name, "cpu"))
    return harness.run_cell(cell, 2 ** 31 + 77, seconds, trace, CPU,
                            time.perf_counter())


# ---------------------------------------------------------------------------
# cells as data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_as_data(name):
    cell = harness.load_cell(name)
    assert harness.load_module("drivers", cell.traffic["driver"]).Session
    for m in cell.per_layer:
        assert callable(harness.load_module("metrics", m["name"]).read)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "peak_mem_gib"}
    assert cell.per_layer
    for lim in cell.limits.values():
        assert lim["lower"] < lim["limit"] < lim["upper"]


def test_every_cell_has_a_tiny_stand_in():
    """Each cell's traffic holds its tests' stand-ins, and its driver the
    faults that the tests plant."""
    assert CELLS
    for name in CELLS:
        tr = harness.load_cell(name).traffic
        assert set(tr["tests"]) == {"cpu", "card"}, name
        assert load_faults(tr["driver"]).KINDS, name


def test_benchmark_json_keeps_the_contract_shape():
    b = bench_json()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
    for c in b["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    assert all(w["chips"] == 1 for w in b["workloads"])


# ---------------------------------------------------------------------------
# the yardstick
# ---------------------------------------------------------------------------

TINY_WIDTHS = {"ped_feature_dim": 6, "obs_feature_dim": 6,
               "encoder_hidden_size": 4, "encoder_hidden_layers": 2,
               "processor_hidden_size": 4, "decoder_hidden_size": 3,
               "decoder_hidden_layers": 2}


@pytest.mark.parametrize("bottleneck,head", [(True, "decoder"),
                                             (False, "processor")])
def test_flops_count_each_linear_layer_once(bottleneck, head):
    w = dict(TINY_WIDTHS, bottleneck=bottleneck, collision_head=head)
    k1, k2 = 2, 3
    enc = 6 * 4 + 4 * 4          # two encoder layers
    proc = 4 * 4                 # one residual block of one layer
    dec = 4 * 3 + 3 * 3 + 3 * 2  # decoder and predictor
    per_edge = enc + proc
    if bottleneck:
        ped = k1 * (per_edge + dec) + k1 * (3 * 3 + 3 * 1)
        obs = k2 * (per_edge + dec)
    else:
        ped = k1 * per_edge + dec + k1 * (4 * 3 + 3 * 1)
        obs = k2 * per_edge + dec
    assert flops.per_agent_frame(w, k1, k2) == 2 * (ped + obs)
    assert flops.train_step(w, k1, k2, 5) == 3 * 5 * 2 * (ped + obs)


def test_layer_list_names_the_program_parameters():
    from piml_tpu_torch.config import PIMLConfig
    from piml_tpu_torch.models import ModelSpec, build_model

    for name in ("pinnsf_bm", "pinnsf_m"):
        conf = harness.read_json(os.path.join(BENCH, "configs", name + ".json"))
        model = build_model(ModelSpec.from_config(PIMLConfig(**conf["settings"])))
        want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        got = {}
        for n, i, o, _ in model_layers.layers(conf["widths"]):
            got[n + ".weight"], got[n + ".bias"] = (o, i), (o,)
        assert got == want


def test_selection_pairs_bytes_and_least_time():
    rows = torch.tensor([[0.0, 0.0], [1.0, 0.0], [5.0, 0.0], [math.nan, 0.0]])
    objs = torch.tensor([[0.0, 3.0], [0.0, 5.0], [4.0, 0.0]])
    # agents: (0,1) within 4 m from both sides; 2 is 4 m from 1 only
    assert selection.pairs_within(rows, None, 4.0) == 4
    # obstacles: (0,a) 3 m, (1,a) sqrt(10), (1,c) 3, (2,c) 1, (0,c) 4
    assert selection.pairs_within(rows, objs, 4.0) == 5
    c = selection.pass_cost(rows, objs, 2, 4.0)
    assert c == {"bytes": 4 * 16 + 3 * 8 + 4 * 2 * 8, "ops": 30}
    peaks = {"hbm_bytes_per_s": 100.0, "f32_ops_nofma": 10.0}
    assert selection.least_seconds([c], peaks) == pytest.approx(3.0)
    # every pass of a frame counts, whatever its size
    nb = {"topk_ped": 2, "topk_obs": 2, "dist_threshold_ped": 4.0,
          "dist_threshold_obs": 4.0}
    assert selection.frame_costs(rows, objs, nb) == [
        selection.pass_cost(rows, None, 2, 4.0), c]


def test_rollout_numbers_read_presence_and_percentiles():
    p = torch.zeros((2, 3, 2))
    a = torch.ones((2, 3, 2))
    same = compare.rollout_numbers([({"p": p, "a": a}, {"p": p, "a": a})])
    assert same == {"pos_gap_max_m": 0.0, "acc_gap_p90": 0.0}
    gone = p.clone()
    gone[1, 0] = math.nan
    out = compare.rollout_numbers([({"p": gone, "a": a}, {"p": p, "a": a})])
    assert out["pos_gap_max_m"] == math.inf


def test_training_numbers_take_the_worst_leaf():
    ref = {"losses": [1.0, 2.0, 4.0],
           "grad_norms": {"a": 1.0, "b": 1.0, "c": 1e-6},
           "change_norms": {"a": 0.1, "b": 0.1, "c": 0.1}}
    prog = {"losses": [1.0, 2.0, 4.4],
            "grad_norms": {"a": 1.0, "b": 1.5, "c": 2e-6},
            "change_norms": {"a": 0.1, "b": 0.1, "c": 0.0}}
    out = compare.training_numbers(prog, ref)
    assert out["loss_gap"] == pytest.approx(0.1)
    assert out["grad_gap"] == pytest.approx(0.5)
    # leaf c moves by round-off alone in the reference: not compared
    assert out["change_gap"] == 0.0


# ---------------------------------------------------------------------------
# the reference against the program, on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CELLS)
def test_reference_meets_the_program(name):
    res = tiny_run(name)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert "setup_s" in res["metrics"]
    assert list(res)[-2:] == ["checks", "_numbers"]


def test_jax_loaded_by_the_check_prints_no_result(monkeypatch, capsys):
    import types

    from benchmark import run

    numbers = compare.rollout_numbers

    def loads_jax(pairs):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return numbers(pairs)

    monkeypatch.setattr(compare, "rollout_numbers", loads_jax)
    res = tiny_run("pinnsf_bm.dense_rollout")
    assert run.report(res) != 0
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err


def test_traced_run_reports_the_slice():
    res = tiny_run("pinnsf_bm.dense_rollout", trace=True)
    assert res["correct"]
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


# ---------------------------------------------------------------------------
# faults in the timed path turn ``correct`` false
# ---------------------------------------------------------------------------

FAULTS = [(c, f) for c in CELLS
          for f in load_faults(harness.load_cell(c).traffic["driver"]).KINDS]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    load_faults(harness.load_cell(name).traffic["driver"]).plant(monkeypatch,
                                                                fault)
    res = tiny_run(name)
    assert not res["correct"], res["checks"]


# ---------------------------------------------------------------------------
# what runs on the chip imports neither JAX nor the JAX package
# ---------------------------------------------------------------------------

def _py_files():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_sources_import_no_jax_and_the_reference_nothing_of_the_program():
    for path in _py_files():
        tree = ast.parse(open(path).read())
        names = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names.append(node.module)
        tops = {n.split(".")[0] for n in names}
        assert not tops & set(harness.FORBIDDEN), (path, tops)
        rel = os.path.relpath(path, BENCH)
        if rel.startswith(("reference", "yardstick")):
            assert "piml_tpu_torch" not in tops, path


def test_a_run_loads_no_jax(tmp_path):
    code = (
        "import sys, time, torch\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from benchmark import harness\n"
        "cell = harness.load_cell('pinnsf_bm.dense_rollout', traffic_override="
        f"{stand_in('pinnsf_bm.dense_rollout', 'cpu')!r})\n"
        "from benchmark import run\n"
        "res = harness.run_cell(cell, 5, 0.2, False, torch.device('cpu'), "
        "time.perf_counter())\n"
        "assert run.report(res) == 0\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert set(json.loads(lines[-2])) >= {"correct", "attempted", "failed",
                                          "metrics", "device"}
    tops = set(json.loads(lines[-1].replace("'", '"')))
    assert "piml_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "pinnsf_bm.dense_rollout", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


# ---------------------------------------------------------------------------
# on a card: the TF32 control fails the limits, the program meets them
# ---------------------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes_on_the_card(card, name):
    from benchmark.calibrate import readings

    cell = harness.load_cell(name, traffic_override=stand_in(name, "card"))
    for seed in (2 ** 31 + 101, 2 ** 31 + 102):
        r = readings(cell, seed, 2, card)
        assert all(v["ok"] for v in compare.judge(r["sound"], cell.limits))
        assert not all(v["ok"] for v in compare.judge(r["control"], cell.limits))

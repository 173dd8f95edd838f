"""The benchmark's social-force cell against the port (CPU, seeded GC
schedules of 40 frames padded to 64 slots, all 4,094 obstacle points).

- ``piml_tpu_torch.gen.socialforce.simulate`` against
  ``benchmark/reference/socialforce.py``, through the numbers that decide
  the cell's ``correct`` (``yardstick/compare.py``): presence equal,
  positions within 1e-5 m and the acceleration gap's 90th percentile
  within 1e-5 of the RMS acceleration.  The reference takes the
  generator's float32 operations in their order, so they read 0 here;
  the same terms in another order read up to 4e-6 m and 4e-8 on the CPU,
  and the tolerances leave room for that.  The reference with its pair
  terms in bfloat16 (the cell's control) reads 5e-4 to 5e-3 m and 1.6e-3
  to 4.3e-3, and fails them;
- padding is inert: the padded slots never enter, and the schedule's own
  slots step as they do unpadded.  Presence is equal bit for bit;
  positions and velocities agree within 1e-5, not bit for bit, because
  the pedestrian sum then runs over 64 terms, and torch's CPU sum groups
  the same terms otherwise when a row is longer (one force component
  moves by 1 ulp at frame 36 of seed 4);
- every seed does the same work: the driver's schedules have the same
  shapes and slot count whatever the run's seed;
- ``benchmark/gc_scenario.py`` draws the port's GC schedules bit for bit;
- the generator's ``frame`` and ``sf.substeps`` spans (one of each a frame
  under a profiler, none without) and its pair counter (``N² + N·M`` a
  sub-step).
"""

import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_compare  # noqa: F401  (shares the cores between workers)
from piml_tpu_torch.gen import scenarios
from piml_tpu_torch.gen import socialforce as sf
from piml_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark import gc_scenario, harness  # noqa: E402
from benchmark.drivers import sf_generate  # noqa: E402
from benchmark.reference import socialforce as ref  # noqa: E402
from benchmark.yardstick import compare, sf_law  # noqa: E402

FRAMES, CAPACITY, SEED = 40, 64, 4
CONFIG = harness.read_json(os.path.join(REPO, "benchmark", "configs",
                                        "socialforce.json"))
PARAMS = sf.SFParams(**{k: CONFIG[k] for k in sf_generate.KNOBS})
KNOBS = sf_generate.knobs(CONFIG)
DT = CONFIG["time_unit"]


def drawn(seed=SEED):
    sched, obstacles = gc_scenario.GC(FRAMES, seed=seed)
    return sched, torch.as_tensor(obstacles.astype(np.float32))


def tensors(arrays):
    return sf.SpawnSchedule(*(torch.as_tensor(arrays[k])
                              for k in sf_generate.FIELDS))


def simulate(arrays, obstacles):
    return sf.simulate(PARAMS, tensors(arrays), obstacles, FRAMES,
                       device="cpu")


@pytest.fixture(scope="module")
def padded_run():
    sched, obstacles = drawn()
    padded = sf_generate.pad(sched, CAPACITY, FRAMES)
    return sched, padded, obstacles, simulate(padded, obstacles)


def reference_numbers(padded, obstacles, ps, vs, pair_dtype):
    s = tensors(padded)
    run = ref.generate(KNOBS, s.spawn_frame, s.position, s.velocity,
                       s.waypoints, s.dest_num, s.desired_speed, obstacles,
                       FRAMES, pair_dtype=pair_dtype)
    prog = {"p": ps, "a": sf_generate.acceleration(s.velocity, vs, DT)}
    return compare.rollout_numbers([(prog, {
        "p": run.p, "a": sf_generate.acceleration(s.velocity, run.v, DT)})])


def test_simulate_matches_the_reference(padded_run):
    sched, padded, obstacles, (ps, vs, act) = padded_run
    n = sched["position"].shape[0]
    live = act.numpy()
    assert obstacles.shape == (4094, 2)
    # late arrivals enter and pedestrians are present to the end
    assert live[0].sum() >= 20 and live[-1].sum() > 20
    assert (sched["spawn_frame"] > 0).sum() > 10 and n < CAPACITY
    sound = reference_numbers(padded, obstacles, ps, vs, torch.float32)
    assert sound["pos_gap_max_m"] <= 1e-5, sound
    assert sound["acc_gap_p90"] <= 1e-5, sound
    control = reference_numbers(padded, obstacles, ps, vs, torch.bfloat16)
    assert (control["pos_gap_max_m"] > 1e-5
            or control["acc_gap_p90"] > 1e-5), control


def test_padding_is_inert(padded_run):
    sched, _, obstacles, (ps, vs, act) = padded_run
    n = sched["position"].shape[0]
    ps0, vs0, act0 = simulate(sched, obstacles)
    assert not act[:, n:].any()
    assert torch.isnan(ps[:, n:]).all() and not vs[:, n:].any()
    assert torch.equal(act[:, :n], act0)
    assert torch.equal(torch.isnan(ps[:, :n]), torch.isnan(ps0))
    np.testing.assert_allclose(ps[:, :n].numpy(), ps0.numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(vs[:, :n].numpy(), vs0.numpy(), rtol=0,
                               atol=1e-5)


def test_every_seed_does_the_same_work():
    """The cell's own traffic: whatever the run's seed, the schedules hold
    the same slots, shapes and dtypes, and the same obstacle table."""
    tr = harness.load_cell("socialforce.gc_generate").traffic
    layouts, tables = set(), []
    for seed in (2 ** 31 + 5, 2 ** 32 + 17, 7, 123456789, 2 ** 33 + 1):
        scheds, obstacles = sf_generate.schedules(tr, CONFIG, seed)
        assert len(scheds) == tr["states"]
        for s in scheds:
            layouts.add(tuple((k, s[k].shape, s[k].dtype.str)
                              for k in sf_generate.FIELDS))
            never = s["spawn_frame"] == tr["schedule_frames"]
            assert 20 < int((~never).sum()) <= tr["capacity"]
        tables.append(obstacles)
    assert len(layouts) == 1
    assert dict((k, shape) for k, shape, _ in next(iter(layouts)))[
        "position"] == (tr["capacity"], 2)
    assert all(o.shape == (tr["obstacles"], 2) for o in tables)
    assert all(np.array_equal(o, tables[0]) for o in tables)


def test_a_draw_past_the_capacity_is_refused():
    sched, _ = drawn()
    with pytest.raises(ValueError, match="exceeds the capacity"):
        sf_generate.pad(sched, sched["position"].shape[0] - 1, FRAMES)


@pytest.mark.parametrize("seed", [0, 666, 2 ** 32 - 1])
def test_gc_scenario_draws_the_port_schedules(seed):
    ours, obstacles = gc_scenario.GC(120, seed=seed)
    theirs, their_obstacles = scenarios.GC(120, seed=seed, device="cpu")
    assert np.array_equal(obstacles, their_obstacles)
    for k in sf_generate.FIELDS:
        got, want = ours[k], getattr(theirs, k).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)


def test_generator_spans_and_pair_counter():
    sched, obstacles = drawn()
    padded = tensors(sf_generate.pad(sched, CAPACITY, FRAMES))
    frames, n, m = 3, CAPACITY, obstacles.shape[0]
    per_frame = PARAMS.oversampling * (n * n + n * m)
    profiling.reset()
    start = sf.PAIRS.ped + sf.PAIRS.obs
    sf.simulate(PARAMS, padded, obstacles, frames, device="cpu")
    assert profiling.spans() == []
    assert sf.PAIRS.ped + sf.PAIRS.obs - start == frames * per_frame
    with profile(activities=[ProfilerActivity.CPU]):
        sf.simulate(PARAMS, padded, obstacles, frames, device="cpu")
    s = profiling.summary()
    assert s["frame"]["count"] == frames
    assert s["sf.substeps"]["count"] == frames
    assert s["sf.substeps"]["stream_s"] is None   # no card
    recs = profiling.spans()
    ids = {r["id"] for r in recs if r["name"] == "frame"}
    assert all(r["parent"] in ids for r in recs
               if r["name"] == "sf.substeps")
    assert sf.PAIRS.ped + sf.PAIRS.obs - start == 2 * frames * per_frame
    profiling.reset()


def test_sf_law_counts_each_term_once():
    assert sf_law.PED_FLOPS == sum(n for _, n in sf_law.PED_TERMS) == 21
    assert sf_law.OBS_FLOPS == sum(n for _, n in sf_law.OBS_TERMS) == 15
    for terms in (sf_law.PED_TERMS, sf_law.OBS_TERMS):
        assert len({t for t, _ in terms}) == len(terms)
    assert sf_law.frame_flops(400, 4094, 10) == 10.0 * (21 * 400 ** 2
                                                        + 15 * 400 * 4094)

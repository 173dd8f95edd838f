"""The benchmark's plain references of the MLAPM generator and of the
evaluation scores against the port and the JAX package (CPU, seeded,
~300 agents, 10 frames).

- ``piml_tpu_torch.gen.simulate_mlapm`` against
  ``benchmark/reference/mlapm.py`` on a schedule with late spawns, slots
  that never spawn, two-waypoint routes and agents that arrive and retire
  inside the run: presence equal, positions within 1e-4 m and velocities
  within 1e-3 m/s (float32 sums over ~300 neighbours in another order,
  carried over 10 frames);
- the reference against the JAX package's ``simulate_mlapm`` on the same
  schedule, which ties it to the published law (same tolerances);
- the row-blocked reference against the unblocked one: each row's sum is
  the same reduction, so the forces agree to 1e-6 relative;
- the generator's ``frame`` and ``mlapm.force`` spans (one of each a frame
  under a profiler, none without) and its pair counter (``N²`` a frame);
- ``evaluate_rollouts``' scores against ``benchmark/reference/scoring.py``
  on the program's own rollout of a tiny dense scene: MSE, MAE and OT
  within 1e-5 relative, the contact totals equal, MMD within 2e-6
  absolute (it is a difference of four kernel sums near 1, so float32
  leaves it ~1e-7 absolute of noise at this size, a few per cent of its
  value).

MLAPM's rotation sign flips with a 1-ulp change of a cross product near
0; uniform random positions put no pair on that edge here.
"""

import dataclasses
import math
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_compare  # noqa: F401  (shares the cores between workers)
from piml_tpu import gen as jgen
from piml_tpu.models import mlapm as jmlapm
from piml_tpu_torch import gen
from piml_tpu_torch.config import PIMLConfig
from piml_tpu_torch.data import make_time_indexed
from piml_tpu_torch.engine import simulator
from piml_tpu_torch.gen.socialforce import SpawnSchedule
from piml_tpu_torch.models import ModelSpec, build_model, mlapm
from piml_tpu_torch.scene import Scene
from piml_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark.drivers import eval_scoring  # noqa: E402
from benchmark.reference import mlapm as ref  # noqa: E402
from benchmark.reference import scoring  # noqa: E402
from benchmark.yardstick import pair_law  # noqa: E402

N, FRAMES, DT, ARRIVE = 300, 10, 0.08, 1.0
PARAMS = mlapm.MLAPMParams.gc_paper()
LAW = ref.Law(PARAMS.tau, PARAMS.A, PARAMS.B, PARAMS.C, PARAMS.D,
              PARAMS.theta)


def schedule_arrays(seed=3):
    """Uniform crowd over 30 m; slots 0-19 spawn at frames 1-4, 20-24
    never (frame ``FRAMES``); slots 30-39 start 1.15-1.5 m short of their
    first waypoint, 30-34 with a second one 15 m on."""
    rng = np.random.RandomState(seed)
    pos = (rng.rand(N, 2) * 30).astype(np.float32)
    vel = rng.randn(N, 2).astype(np.float32)
    wps = np.full((2, N, 2), np.nan, np.float32)
    wps[0] = rng.rand(N, 2) * 30
    heading = vel[30:40] / np.linalg.norm(vel[30:40], axis=1, keepdims=True)
    wps[0, 30:40] = pos[30:40] + heading * rng.uniform(1.15, 1.5, (10, 1))
    wps[1, 30:35] = wps[0, 30:35] + 15.0 * heading[:5]
    dest_num = np.ones(N, np.int64)
    dest_num[30:35] = 2
    spawn = np.zeros(N, np.int32)
    spawn[:20] = rng.randint(1, 5, 20)
    spawn[20:25] = FRAMES
    ds = (1.2 + 0.3 * rng.rand(N)).astype(np.float32)
    return dict(spawn_frame=spawn, position=pos, velocity=vel, waypoints=wps,
                dest_num=dest_num, desired_speed=ds)


def torch_schedule(a):
    return SpawnSchedule(*(torch.from_numpy(a[k]) for k in (
        "spawn_frame", "position", "velocity", "waypoints", "dest_num",
        "desired_speed")))


def reference_run(a, **kw):
    s = torch_schedule(a)
    return ref.generate(LAW, s.spawn_frame, s.position, s.velocity,
                        s.waypoints, s.dest_num, s.desired_speed, FRAMES, DT,
                        ARRIVE, **kw)


def assert_runs_match(p, v, act, run):
    np.testing.assert_array_equal(np.asarray(act), run.active.numpy())
    np.testing.assert_array_equal(np.isnan(np.asarray(p)),
                                  np.isnan(run.p.numpy()))
    np.testing.assert_allclose(np.asarray(p), run.p.numpy(), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(v), run.v.numpy(), rtol=0,
                               atol=1e-3)


def test_simulate_mlapm_matches_the_reference():
    a = schedule_arrays()
    ps, vs, act = gen.simulate_mlapm(PARAMS, torch_schedule(a), FRAMES,
                                     dt=DT, arrive_distance=ARRIVE,
                                     device="cpu")
    run = reference_run(a)
    assert_runs_match(ps.numpy(), vs.numpy(), act.numpy(), run)
    live = run.active.numpy()
    # late spawns, slots never spawned, retirements inside the run
    assert live[0, :20].sum() < 20 and live[-1, :20].sum() > 0
    assert not live[:, 20:25].any()
    retired = (live[:-1] == 1) & (live[1:] == 0)
    assert retired.sum() >= 3
    # a two-waypoint agent moved on to its second waypoint
    assert live[-1, 30:35].sum() >= 1


def test_reference_matches_the_jax_simulation():
    a = schedule_arrays(seed=5)
    jsched = jgen.SpawnSchedule(*(jnp.asarray(a[k]) for k in (
        "spawn_frame", "position", "velocity", "waypoints", "dest_num",
        "desired_speed")))
    jp, jv, jact = jgen.simulate_mlapm(jmlapm.MLAPMParams.gc_paper(), jsched,
                                       FRAMES, dt=DT, arrive_distance=ARRIVE)
    assert_runs_match(jp, jv, jact, reference_run(a))


def test_row_blocked_reference_matches_unblocked():
    a = schedule_arrays(seed=7)
    p = torch.from_numpy(a["position"])
    p[50:60] = math.nan
    v = torch.from_numpy(a["velocity"])
    ds = torch.from_numpy(a["desired_speed"])
    dest = torch.from_numpy(a["waypoints"][0])
    whole = ref.force(LAW, p, v, ds, dest, block=N)
    for rows in (1, 7, 64):
        np.testing.assert_allclose(ref.force(LAW, p, v, ds, dest,
                                             block=rows).numpy(),
                                   whole.numpy(), rtol=1e-6, atol=1e-6)
    assert not whole[50:60].any() and torch.isfinite(whole).all()
    run, blocked = reference_run(a), reference_run(a, block=13)
    np.testing.assert_allclose(blocked.p.numpy(), run.p.numpy(), rtol=0,
                               atol=1e-5)


def test_generator_spans_and_pair_counter():
    a = schedule_arrays()
    sched = torch_schedule(a)
    profiling.reset()
    start = mlapm.PAIRS.pairs
    gen.simulate_mlapm(PARAMS, sched, FRAMES, device="cpu")
    assert profiling.spans() == []
    assert mlapm.PAIRS.pairs - start == FRAMES * N * N
    with profile(activities=[ProfilerActivity.CPU]):
        gen.simulate_mlapm(PARAMS, sched, FRAMES, device="cpu")
    s = profiling.summary()
    assert s["frame"]["count"] == FRAMES
    assert s["mlapm.force"]["count"] == FRAMES
    assert s["mlapm.force"]["stream_s"] is None   # no card
    recs = profiling.spans()
    frames = {r["id"] for r in recs if r["name"] == "frame"}
    assert all(r["parent"] in frames for r in recs
               if r["name"] == "mlapm.force")
    assert mlapm.PAIRS.pairs - start == 2 * FRAMES * N * N
    profiling.reset()


def test_pair_law_counts_each_term_once():
    assert pair_law.PAIR_FLOPS == sum(n for _, n in pair_law.TERMS) == 44
    assert len({t for t, _ in pair_law.TERMS}) == len(pair_law.TERMS)
    assert pair_law.frame_flops(12685) == 44.0 * 12685 ** 2


def test_evaluate_rollouts_matches_reference_scoring():
    settings = dict(model="pinnsf_bm", dataset_name="gc2344", dropout=0.0,
                    skip_frames=25, time_unit=DT, topk_ped=6, topk_obs=10)
    cfg = PIMLConfig(**settings)
    tr = dict(agents=200, obstacles=32, extent=25.0, states=1)
    arrays = eval_scoring.dense_scenes(tr, 11, torch.device("cpu"),
                                       cfg.skip_frames + 10, DT)[0]
    # agent 0 meets its waypoint early and leaves the prediction
    arrays["waypoints"][0, 0] = arrays["position"][26, 0]
    arrays["destination"][:, 0] = arrays["waypoints"][0, 0]
    data = make_time_indexed(cfg, Scene.from_arrays(arrays, "cpu"))
    torch.manual_seed(0)
    model = build_model(ModelSpec.from_config(cfg)).eval()
    got = dataclasses.asdict(simulator.evaluate_rollouts(
        model, cfg, [data], test_flag=True))
    ecfg = simulator.engine_config(cfg, retire=True, track_collisions=False,
                                   track_labels=False)
    res = simulator.eval_rollout(model, ecfg, data, cfg.skip_frames)
    assert bool(torch.isnan(res.position[cfg.skip_frames:, 0]).any())
    want = scoring.scores(res.position, data.mask_p_pred, data.position,
                          data.waypoints, data.dest_num, cfg.skip_frames,
                          cfg.collision_threshold)
    for k in ("loss", "mse", "mae", "ot"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    assert got["mmd"] == pytest.approx(want["mmd"], rel=0, abs=2e-6)
    assert want["mmd"] > 0
    assert got["collision"] == want["collision"] > 0
    assert got["hard_collision"] == want["hard_collision"]

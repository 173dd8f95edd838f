"""The port's main path end to end against the JAX package (CPU): a 60-frame
slice of the committed GC scene (all 337 agents, 4,094 obstacle points,
``skip_frames=25``) through ``make_time_indexed`` and ``evaluate_rollouts``
with the trained ``pinnsf_bm`` weights.

Tolerances: ``mse``, ``mae`` and both collision counts to rtol 1e-4;
trajectories to atol 1e-4 m (float32 rounding, summed in other orders,
compounds over 35 closed-loop frames); features as in
``_torch_compare.assert_features_match``.
"""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from flax.serialization import msgpack_restore

from _torch_compare import assert_features_match
from piml_tpu.config import PIMLConfig as JaxConfig
from piml_tpu.data import make_time_indexed as jax_make_time_indexed
from piml_tpu.engine import engine_config as jax_engine_config
from piml_tpu.engine import eval_rollout as jax_eval_rollout
from piml_tpu.engine import evaluate_rollouts as jax_evaluate
from piml_tpu.engine.rollout import EngineConfig as JaxEngineConfig
from piml_tpu.engine.rollout import SpawnFrame as JaxSpawnFrame
from piml_tpu.engine.rollout import init_state as jax_init_state
from piml_tpu.engine.rollout import make_step as jax_make_step
from piml_tpu.engine.rollout import select_waypoint as jax_select_waypoint
from piml_tpu.models import ModelSpec as JaxSpec, build_model as jax_build
from piml_tpu.physics import NeighborConfig as JaxNeighborConfig
from piml_tpu.physics import heading_direction as jax_heading_direction
from piml_tpu.physics import relative_features as jax_features
from piml_tpu.scene import Scene as JaxScene
from piml_tpu_torch.config import PIMLConfig
from piml_tpu_torch.data import make_time_indexed
from piml_tpu_torch.engine import (EngineConfig, SpawnFrame, engine_config,
                                   eval_rollout, evaluate_rollouts,
                                   init_state, make_step, select_waypoint)
from piml_tpu_torch.models import ModelSpec, build_model, load_fixture
from piml_tpu_torch.physics import NeighborConfig
from piml_tpu_torch.scene import Scene, codec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "repro_work", "gc_sf_repro.npy")
MSGPACK = os.path.join(REPO, "bench_fixtures", "pinnsf_bm_gc_finetuned.msgpack")
FRAMES = 60
CFG = dict(model="pinnsf_bm", dataset_name="gc2344", dropout=0.0,
           skip_frames=25, time_unit=0.08)
T_KEYED = ("position", "velocity", "acceleration", "destination", "dest_idx",
           "mask_p", "mask_v", "mask_a")


@pytest.fixture(scope="module")
def gc_slice():
    """Both packages' datasets and models on the same decoded arrays."""
    arrays = codec.decode(SCENE)
    for key in T_KEYED:
        arrays[key] = arrays[key][:FRAMES]
    jcfg, tcfg = JaxConfig(**CFG), PIMLConfig(**CFG)
    jdata = jax_make_time_indexed(jcfg, JaxScene.from_arrays(arrays))
    with open(MSGPACK, "rb") as f:
        params = msgpack_restore(f.read())
    jmodel = jax_build(JaxSpec.from_config(jcfg))

    def apply_fn(pr, pf, of, sf):
        return jmodel.apply(pr, pf, of, sf)

    tdata = make_time_indexed(tcfg, Scene.from_arrays(arrays, device="cpu"))
    model = build_model(ModelSpec.from_config(tcfg))
    model.load_state_dict(load_fixture())
    model.eval()
    return dict(jcfg=jcfg, tcfg=tcfg, jdata=jdata, tdata=tdata,
                params=params, apply_fn=apply_fn, model=model)


def test_scene_load_matches_jax():
    ref = JaxScene.load(SCENE)
    got = Scene.load(SCENE, device="cpu")
    for key in T_KEYED + ("waypoints", "dest_num", "obstacles"):
        np.testing.assert_allclose(getattr(got, key).numpy(),
                                   np.asarray(getattr(ref, key)),
                                   rtol=1e-6, atol=1e-5, err_msg=key)
    assert got.num_steps == ref.num_steps == 750
    assert got.num_pedestrians == ref.num_pedestrians == 337


def test_make_time_indexed_matches_jax(gc_slice):
    jd, td = gc_slice["jdata"], gc_slice["tdata"]
    cfg = gc_slice["tcfg"]
    assert_features_match(jd.ped_features, td.ped_features.numpy(),
                          cfg.dist_threshold_ped, name="gc/ped")
    assert_features_match(jd.obs_features, td.obs_features.numpy(),
                          cfg.dist_threshold_obs, name="gc/obs")
    for key in ("self_features", "labels", "desired_speed", "mask_p_pred",
                "mask_a_pred", "abnormal_mask"):
        np.testing.assert_allclose(getattr(td, key).numpy(),
                                   np.asarray(getattr(jd, key)),
                                   atol=1e-5, err_msg=key)


def test_eval_rollout_trajectories_match_jax(gc_slice):
    g = gc_slice
    ref = jax_eval_rollout(
        g["params"], g["apply_fn"],
        jax_engine_config(g["jcfg"], retire=True, track_collisions=False,
                          track_labels=False),
        g["jdata"], CFG["skip_frames"])
    got = eval_rollout(
        g["model"],
        engine_config(g["tcfg"], retire=True, track_collisions=False,
                      track_labels=False),
        g["tdata"], CFG["skip_frames"])
    np.testing.assert_array_equal(got.mask_p.numpy(), np.asarray(ref.mask_p))
    p_ref, p_got = np.asarray(ref.position), got.position.numpy()
    np.testing.assert_array_equal(np.isnan(p_got), np.isnan(p_ref))
    np.testing.assert_allclose(p_got, p_ref, rtol=0, atol=1e-4)
    assert np.isfinite(p_got[got.mask_p.numpy() == 1]).all()


def test_evaluate_rollouts_matches_jax(gc_slice):
    g = gc_slice
    ref = jax_evaluate(g["params"], g["apply_fn"], g["jcfg"], [g["jdata"]],
                       test_flag=True)
    got = evaluate_rollouts(g["model"], g["tcfg"], [g["tdata"]],
                            test_flag=True)
    for key in ("loss", "mse", "mae", "collision", "hard_collision"):
        assert getattr(got, key) == pytest.approx(getattr(ref, key),
                                                  rel=1e-4), key
    # OT and MMD per frame with predictable agents, at the tolerances of
    # tests/test_torch_metrics.py
    assert got.ot == pytest.approx(ref.ot, rel=1e-4, abs=1e-5)
    assert got.mmd == pytest.approx(ref.mmd, rel=1e-4, abs=1e-6)
    assert got.collision > 0 and got.mse > 0 and got.ot > 0 and got.mmd > 0


def test_validation_loss_matches_jax(gc_slice):
    """The finetune's validation metric: ``test_flag=False`` adds the
    weighted collision counts to the rollout MSE and computes no MAE."""
    g = gc_slice
    ref = jax_evaluate(g["params"], g["apply_fn"], g["jcfg"], [g["jdata"]],
                       test_flag=False)
    got = evaluate_rollouts(g["model"], g["tcfg"], [g["tdata"]],
                            test_flag=False)
    for key in ("loss", "mse", "collision", "hard_collision"):
        assert getattr(got, key) == pytest.approx(getattr(ref, key),
                                                  rel=1e-4), key
    assert got.loss > got.mse and got.mae == 0.0


GC_FIXTURE = os.path.join(REPO, "piml_tpu_torch", "fixtures",
                          "gc_window_jax.npz")
SPREAD_FACTOR = 3


def test_gc_window_first_150_frames_match_jax_fixture():
    """The first 151 frames of the whole GC window (all 337 agents) against
    the JAX package's numbers in ``piml_tpu_torch/fixtures/gc_window_jax.npz``
    (``tools/make_gc_window_fixture.py``).  The whole 750-frame window
    takes ~140 s on this CPU, so it is held to the fixture on the card
    (``chip_smoke.py`` phase 7); this test holds its first 151 frames.

    Why the tolerance is that wide: the closed loop is chaotic.  Moving
    every scene position by at most 1e-4 m (the size of the two packages'
    matmul-expansion near-ties) moves the JAX package's own metrics by up
    to the fixture's ``spread_short`` (over six such runs: collisions 9.7 %,
    hard collisions 13.6 %, the rest 0.5-1.0 %) and its positions by the
    median gaps of ``spread_median``.  The port is held to three times
    that spread: four runs moved by at most 1e-6 m reached 1.8 times the
    1e-4 m runs' largest collision deviation over the whole window
    (``tools/make_gc_window_fixture.py --perturb 1e-6 --seeds 4``).  The
    first recorded frame (60) is also held to 1e-4 m for every agent, as
    the 60-frame slice is, and the presence masks must agree."""
    import hashlib

    from piml_tpu_torch.engine import engine_config, eval_rollout

    fx = np.load(GC_FIXTURE)
    with open(SCENE, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == str(
            fx["scene_sha256"])
    short = int(fx["short_frames"])
    arrays = codec.decode(SCENE)
    for key in T_KEYED:
        arrays[key] = arrays[key][:short]
    cfg = PIMLConfig(**CFG)
    data = make_time_indexed(cfg, Scene.from_arrays(arrays, device="cpu"))
    model = build_model(ModelSpec.from_config(cfg))
    model.load_state_dict(load_fixture())
    model.eval()
    got = evaluate_rollouts(model, cfg, [data], test_flag=True)
    gaps = {}
    for name, ref, spread in zip(fx["metric_names"], fx["metrics_short"],
                                 fx["spread_short"]):
        gaps[str(name)] = abs(getattr(got, str(name)) - ref) / abs(ref)
        assert gaps[str(name)] <= SPREAD_FACTOR * spread, (name, gaps)
    res = eval_rollout(model, engine_config(cfg, retire=True,
                                            track_collisions=False,
                                            track_labels=False),
                       data, cfg.skip_frames)
    for i, frame in enumerate(fx["frames"]):
        if frame >= short:
            continue
        pos, ref = res.position[frame].numpy(), fx["position"][i]
        np.testing.assert_array_equal(res.mask_p[frame].numpy(),
                                      fx["mask"][i])
        np.testing.assert_array_equal(np.isnan(pos), np.isnan(ref))
        live = np.isfinite(ref).all(-1)
        dist = np.linalg.norm(pos[live] - ref[live], axis=-1)
        assert np.median(dist) <= SPREAD_FACTOR * fx["spread_median"][i]
        if i == 0:
            assert dist.max() <= 1e-4, dist.max()
    print("metric gaps (relative):", gaps)


def test_select_waypoint_matches_jax(rng):
    wp = rng.randn(4, 30, 2).astype(np.float32)
    wp[2:, ::3] = np.nan
    idx = rng.randint(0, 4, size=30).astype(np.int32)
    idx[::3] = np.minimum(idx[::3], 1)
    ref = jax_select_waypoint(jnp.asarray(wp), jnp.asarray(idx))
    got = select_waypoint(torch.from_numpy(wp), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_port_imports_no_jax():
    """The port and every module of it import neither JAX, flax nor the JAX
    package (an H100 host has none of them)."""
    code = (
        "import sys, pkgutil, importlib, piml_tpu_torch\n"
        "for m in pkgutil.walk_packages(piml_tpu_torch.__path__, "
        "'piml_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'piml_tpu')]\n"
        "assert not bad, bad\n"
        "assert 'piml_tpu_torch.parallel.agent_shard' in sys.modules\n"
        "print('ok', len([m for m in sys.modules "
        "if m.startswith('piml_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("entry", [
    "Scene.load", "Scene.from_arrays", "load_scenes", "_Orchestrator",
    "PointwiseDataset", "FinetuneDataset", "VisDataset", "exp.run",
    "exp.collision_eval", "SCENARIOS[crosswalk]",
    "SCENARIOS[four_directional_square]", "SCENARIOS[basic_unit1]",
    "SCENARIOS[basic_unit2]", "SCENARIOS[basic_unit3]", "SCENARIOS[GC]",
    "simulate", "simulate_mlapm", "circle_demo", "to_scene",
    "regenerate_scenario_npy", "regenerate_scene", "piml_loop",
    "RatioSplitDataset", "SceneListSplitDataset", "OnlyTrainingDataset",
    "export_splits", "run_staged_experiment", "run_gc_experiment.run",
    "run_symbolic_regression.run", "repro.run"])
def test_entry_points_default_to_the_card(entry):
    """Every entry point that places data runs on the card unless the
    caller asks for the CPU: its ``device`` parameter defaults to CUDA."""
    import inspect

    from piml_tpu_torch import gen
    from piml_tpu_torch.data import datasets, processing
    from piml_tpu_torch.exp import (experiment, iterate, repro,
                                    run_gc_experiment,
                                    run_symbolic_regression)
    from piml_tpu_torch.exp import main as exp_main

    fn = {"Scene.load": Scene.load, "Scene.from_arrays": Scene.from_arrays,
          "load_scenes": datasets.load_scenes,
          "_Orchestrator": datasets._Orchestrator,
          "PointwiseDataset": datasets.PointwiseDataset,
          "FinetuneDataset": datasets.FinetuneDataset,
          "VisDataset": datasets.VisDataset,
          "exp.run": exp_main.run,
          "exp.collision_eval": exp_main.collision_eval,
          "simulate": gen.simulate, "simulate_mlapm": gen.simulate_mlapm,
          "circle_demo": gen.circle_demo, "to_scene": gen.to_scene,
          "regenerate_scenario_npy": gen.regenerate_scenario_npy,
          "regenerate_scene": iterate.regenerate_scene,
          "piml_loop": iterate.piml_loop,
          "RatioSplitDataset": datasets.RatioSplitDataset,
          "SceneListSplitDataset": datasets.SceneListSplitDataset,
          "OnlyTrainingDataset": datasets.OnlyTrainingDataset,
          "export_splits": processing.export_splits,
          "run_staged_experiment": experiment.run_staged_experiment,
          "run_gc_experiment.run": run_gc_experiment.run,
          "run_symbolic_regression.run": run_symbolic_regression.run,
          "repro.run": repro.run,
          **{f"SCENARIOS[{name}]": fn
             for name, fn in gen.SCENARIOS.items()}}[entry]
    default = inspect.signature(fn).parameters["device"].default
    assert torch.device(default).type == "cuda"


@pytest.mark.parametrize("cli", ["generate", "iterate", "run_gc_experiment",
                                 "run_symbolic_regression", "repro"])
def test_new_clis_refuse_to_run_without_a_gpu(monkeypatch, cli):
    """``exp.generate.main``, ``exp.iterate.main`` and the reproduction's
    three CLIs run on ``cuda:0`` only, like ``exp.main.main``: no CPU
    fallback."""
    import importlib

    mod = importlib.import_module(f"piml_tpu_torch.exp.{cli}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"generate": ["--scenario", "GC", "--frames", "5", "--out",
                         os.devnull],
            "iterate": ["--data_config", os.devnull, "--epochs", "1"],
            "run_gc_experiment": ["--stage", "evaluate"],
            "run_symbolic_regression": ["--gp", "0"],
            "repro": ["--smoke"]}[cli]
    with pytest.raises(SystemExit, match="CUDA GPU"):
        mod.main(argv)


@pytest.mark.parametrize("lagged,retire,track", [(True, True, False),
                                                 (False, False, True)])
def test_make_step_matches_jax(rng, lagged, retire, track):
    """One engine step on the same state in both packages: Euler variant,
    waypoint advance and arrival, teleport-in, collision bookkeeping and
    the feature rebuild."""
    n, m, d = 40, 50, 3
    p = (rng.rand(n, 2) * 8).astype(np.float32)
    p[:3] = np.nan
    v = rng.randn(n, 2).astype(np.float32)
    a = (0.3 * rng.randn(n, 2)).astype(np.float32)
    wp = (rng.rand(d, n, 2) * 8).astype(np.float32)
    wp[2, ::2] = np.nan
    dest_num = np.where(np.arange(n) % 2 == 0, 2, 3).astype(np.int32)
    dest_idx = (np.arange(n) % 2).astype(np.int32)
    dest = wp[dest_idx, np.arange(n)]
    dest[5:12] = p[5:12] + 0.1          # arrivals / waypoint advances
    obs = (rng.rand(m, 2) * 8).astype(np.float32)
    ds = np.full((n, 1), 1.3, np.float32)
    pf, of, df = (np.array(x) for x in jax_features(
        jnp.asarray(p), jnp.asarray(v), jnp.asarray(a), jnp.asarray(dest),
        jnp.asarray(obs), JaxNeighborConfig()))
    sf = np.concatenate([df, v, a, ds], axis=-1)
    new = np.zeros(n, np.float32)
    new[:2] = 1.0
    spawn = [new, (rng.rand(n, 2) * 8).astype(np.float32),
             rng.randn(n, 2).astype(np.float32),
             np.zeros((n, 2), np.float32), wp[0].copy(),
             np.zeros(n, np.int32), rng.randn(n, 2).astype(np.float32)]
    spawn[4][np.isnan(spawn[4])] = 0.0

    kw = dict(lagged=lagged, retire_on_arrival=retire,
              track_collisions=track, track_collision_labels=track)
    with open(MSGPACK, "rb") as f:
        params = msgpack_restore(f.read())
    jmodel = jax_build(JaxSpec.from_config(JaxConfig(**CFG)))
    jstep = jax_make_step(lambda pr, a_, b_, c_: jmodel.apply(pr, a_, b_, c_),
                          JaxEngineConfig(**kw), jnp.asarray(wp),
                          jnp.asarray(dest_num), jnp.asarray(obs),
                          jnp.asarray(ds))
    jstate = jax_init_state(*(jnp.asarray(x) for x in
                              (p, v, a, dest, dest_idx, pf, of, sf)))
    jnew, jout = jstep(params, jstate,
                       JaxSpawnFrame(*(jnp.asarray(x) for x in spawn)))

    model = build_model(ModelSpec.from_config(PIMLConfig(**CFG)))
    model.load_state_dict(load_fixture())
    model.eval()
    def t(x):
        return torch.from_numpy(np.array(x))

    tstep = make_step(model, EngineConfig(**kw), t(wp), t(dest_num), t(obs),
                      t(ds))
    tstate = init_state(*(t(x) for x in (p, v, a, dest, dest_idx, pf, of,
                                         sf)))
    with torch.inference_mode():
        tnew, tout = tstep(tstate, SpawnFrame(*(t(x) for x in spawn)))

    for key in ("p", "v", "a", "dest", "dest_idx", "hist_v", "self_f"):
        np.testing.assert_allclose(getattr(tnew, key).numpy(),
                                   np.asarray(getattr(jnew, key)),
                                   atol=1e-5, err_msg=key)
    assert_features_match(jnew.ped_f, tnew.ped_f.numpy(), 4.0, name="ped_f")
    assert_features_match(jnew.obs_f, tnew.obs_f.numpy(), 4.0, name="obs_f")
    for key in ("p", "mask", "collisions", "hard_collisions", "coll_pred",
                "true_coll"):
        np.testing.assert_allclose(getattr(tout, key).numpy(),
                                   np.asarray(getattr(jout, key)),
                                   atol=1e-5, err_msg=key)
    assert float(tout.msg_l1) == pytest.approx(float(jout.msg_l1), rel=1e-5)
    if track:
        assert float(tout.collisions.sum()) > 0


def test_step_counts_collisions_on_a_detached_position(rng, monkeypatch):
    """The per-step contact counts see ``state.p`` without its autograd
    history (the JAX package's ``stop_gradient(state.p)``), so a training
    step records no (…, N, N, 2) pair tensor in its graph."""
    import importlib

    trollout = importlib.import_module("piml_tpu_torch.engine.rollout")

    seen = []
    real = trollout.collision_detection_single_frame

    def spy(position, threshold):
        seen.append(position.requires_grad)
        return real(position, threshold)

    monkeypatch.setattr(trollout, "collision_detection_single_frame", spy)
    n = 30
    p = torch.from_numpy((rng.rand(n, 2) * 4).astype(np.float32))
    p.requires_grad_(True)
    z = torch.zeros(n, 2)
    state = init_state(p, z, z, z, torch.zeros(n, dtype=torch.int32),
                       torch.zeros(n, 6, 6), torch.zeros(n, 10, 6),
                       torch.zeros(n, 7))
    model = build_model(ModelSpec.from_config(PIMLConfig(**CFG)))
    step = make_step(model, EngineConfig(track_collisions=True),
                     torch.zeros(1, n, 2), torch.ones(n, dtype=torch.int32),
                     torch.zeros(4, 2), torch.ones(n, 1))
    _, out = step(state, SpawnFrame(torch.zeros(n), z, z, z, z,
                                    torch.zeros(n, dtype=torch.int32), z))
    assert seen == [False]          # one call: both thresholds
    assert float(out.collisions.sum()) > 0


def test_batched_rollout_matches_jax(rng):
    """Three frames of the channel-batched rollout (C = 2, N = 1,536 past
    the pair gate, use_pallas_topk=False so both packages take the
    channel-batched banded route; JAX in interpret mode) from the same
    state, with teleport-ins and collision bookkeeping: positions to
    1e-4 m, counts exactly."""
    from piml_tpu.engine.rollout import batched_rollout as jax_batched
    from piml_tpu_torch.engine import batched_rollout

    C, n, m, T = 2, 1536, 64, 3
    p = (rng.rand(C, n, 2) * 60).astype(np.float32)
    p[:, :20] = np.nan                               # absent until spawned
    v = rng.randn(C, n, 2).astype(np.float32)
    a = (0.3 * rng.randn(C, n, 2)).astype(np.float32)
    wp = (rng.rand(2, n, 2) * 60).astype(np.float32)
    dest = np.broadcast_to(wp[0], (C, n, 2)).copy()
    obs = (rng.rand(m, 2) * 60).astype(np.float32)
    ds = np.full((n, 1), 1.3, np.float32)
    ncfg_kw = dict(use_pallas_topk=False)
    head = jax_heading_direction(jnp.asarray(np.nan_to_num(v)),
                                 time_axis=False)
    pf, of, df = (np.array(x) for x in jax_features(
        jnp.asarray(p), jnp.asarray(v), jnp.asarray(a), jnp.asarray(dest),
        jnp.asarray(obs), JaxNeighborConfig(**ncfg_kw), heading=head,
        batched=True))
    sf = np.concatenate([df, v, a, np.broadcast_to(ds, (C, n, 1))], axis=-1)
    new = np.zeros((C, T, n), np.float32)
    new[:, 1, :10] = 1.0
    spawn = [new, (rng.rand(C, T, n, 2) * 60).astype(np.float32),
             rng.randn(C, T, n, 2).astype(np.float32),
             np.zeros((C, T, n, 2), np.float32),
             np.broadcast_to(wp[0], (C, T, n, 2)).copy(),
             np.zeros((C, T, n), np.int32),
             rng.randn(C, T, n, 2).astype(np.float32)]
    dest_idx = np.zeros((C, n), np.int32)
    dest_num = np.full(n, 2, np.int32)
    kw = dict(retire_on_arrival=False, track_collisions=True,
              track_collision_labels=True, remat=False)

    with open(MSGPACK, "rb") as f:
        params = msgpack_restore(f.read())
    jmodel = jax_build(JaxSpec.from_config(JaxConfig(**CFG)))
    _, jout = jax_batched(
        params, lambda pr, a_, b_, c_: jmodel.apply(pr, a_, b_, c_),
        JaxEngineConfig(neighbor=JaxNeighborConfig(**ncfg_kw), **kw),
        jax_init_state(*(jnp.asarray(x) for x in
                         (p, v, a, dest, dest_idx, pf, of, sf))),
        JaxSpawnFrame(*(jnp.asarray(x) for x in spawn)), jnp.asarray(wp),
        jnp.asarray(dest_num), jnp.asarray(obs), jnp.asarray(ds))

    def t(x):
        return torch.from_numpy(np.array(x))

    model = build_model(ModelSpec.from_config(PIMLConfig(**CFG)))
    model.load_state_dict(load_fixture())
    with torch.no_grad():
        _, tout = batched_rollout(
            model, EngineConfig(neighbor=NeighborConfig(**ncfg_kw), **kw),
            init_state(*(t(x) for x in (p, v, a, dest, dest_idx, pf, of,
                                        sf))),
            SpawnFrame(*(t(x) for x in spawn)), t(wp), t(dest_num), t(obs),
            t(ds))
    assert tout.p.shape == (C, T, n, 2)
    p_ref, p_got = np.asarray(jout.p), tout.p.numpy()
    np.testing.assert_array_equal(np.isnan(p_got), np.isnan(p_ref))
    np.testing.assert_allclose(p_got, p_ref, rtol=0, atol=1e-4)
    for key in ("mask", "collisions", "hard_collisions", "true_coll"):
        np.testing.assert_array_equal(getattr(tout, key).numpy(),
                                      np.asarray(getattr(jout, key)),
                                      err_msg=key)
    np.testing.assert_allclose(tout.msg_l1.numpy(), np.asarray(jout.msg_l1),
                               rtol=1e-5)
    assert float(tout.collisions.sum()) > 0

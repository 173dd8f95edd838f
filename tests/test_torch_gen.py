"""The port's discovery-loop generators against the JAX package (CPU):
polar transforms, the polar views, routes and scenario schedules, the
social-force and MLAPM force laws and simulators, ``to_scene`` and
``regenerate_scene``.

Tolerances:
- polar radii rtol 1e-6; angles atol 1e-4 (the acos clamp at ±(1 − 1e-6)
  amplifies a 1-ulp cosine difference up to ~700×); NaN positions equal;
- routes, schedules and obstacles: bitwise (the same numpy code);
- force laws: rtol 1e-5, atol 1e-6;
- simulators: positions within 1e-4 m over 20-30 frames (200 for the
  circle demo), active masks equal;
- ``to_scene`` on the same run: arrays equal.

MLAPM's rotation sign ``-sign(cross(vr, ed))`` flips with a 1-ulp change
when the cross product is near 0; the seeded inputs here are uniform
random positions, so no pair is collinear with a destination direction.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_compare import assert_features_match
from piml_tpu import gen as jgen
from piml_tpu.config import PIMLConfig as JaxConfig
from piml_tpu.data import PointwiseDataset as JaxPointwiseDataset
from piml_tpu.exp import iterate as jiterate
from piml_tpu.models import mlapm as jmlapm
from piml_tpu.physics import polar as jpolar
from piml_tpu.scene import Scene as JaxScene
from piml_tpu_torch import gen
from piml_tpu_torch.config import PIMLConfig
from piml_tpu_torch.data import PointwiseDataset
from piml_tpu_torch.exp import iterate
from piml_tpu_torch.models import mlapm
from piml_tpu_torch.physics import polar
from piml_tpu_torch.scene import Scene, crop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "repro_work", "gc_sf_repro.npy")
SCENE_FIELDS = ("position", "velocity", "acceleration", "destination",
                "waypoints", "dest_idx", "dest_num", "obstacles", "mask_p",
                "mask_v", "mask_a")


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_polar(got, ref, r_atol=1e-7, collinear_ok=False):
    """(r, θ) pairs: radii rtol 1e-6 (plus ``r_atol``), angles atol 1e-4,
    NaN where NaN.

    With ``collinear_ok`` an angle may also differ where the vector is
    collinear with its base (|θ| at the clamp: ~0.0014 or ~3.1402) and one
    side reads 0: the sign there is the sign of a cross product that is 0
    up to rounding, which XLA's fused multiply-add on the CPU keeps and two
    roundings in torch (as in the reference) do not.  Returns the count of
    such angles."""
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got[..., 0::2], ref[..., 0::2], rtol=1e-6,
                               atol=r_atol)
    ga, ra = np.nan_to_num(got[..., 1::2]), np.nan_to_num(ref[..., 1::2])
    bad = np.abs(ga - ra) > 1e-4
    if collinear_ok:
        def at_clamp(a):
            return np.minimum(np.abs(a), np.pi - np.abs(a)) < 2e-3

        mag = np.maximum(np.abs(ga), np.abs(ra))
        sign_only = (at_clamp(mag) & ((ga == 0) | (ra == 0)
                                      | (np.abs(np.abs(ga) - mag) < 1e-4)))
        bad &= ~sign_only
    assert not bad.any(), (
        f"{bad.sum()} angles differ, e.g. {ga[bad][:5]} vs {ra[bad][:5]}")
    return int((np.abs(ga - ra) > 1e-4).sum())


# ---------------------------------------------------------------------------
# polar transforms and views
# ---------------------------------------------------------------------------

def _polar_inputs(rng, shape):
    pts = rng.randn(*shape, 2).astype(np.float32) * 3
    base = rng.randn(*shape, 2).astype(np.float32)
    base /= np.linalg.norm(base, axis=-1, keepdims=True)
    flat_p, flat_b = pts.reshape(-1, 2), base.reshape(-1, 2)
    flat_p[::9] = 0.0                  # zero vectors
    flat_p[4::13] = np.nan             # absent rows
    flat_b[7::17] = np.nan
    return pts, base


@pytest.mark.parametrize("fn", ["cart_to_polar", "polar_to_cart",
                                "features_to_polar"])
def test_polar_transforms_match_jax(rng, fn):
    if fn == "features_to_polar":
        feats = rng.randn(40, 6, 6).astype(np.float32) * 2
        feats[:, 4:] = 0.0              # zero-padded neighbour slots
        feats[3] = np.nan
        heading = rng.randn(40, 2).astype(np.float32)
        heading /= np.linalg.norm(heading, axis=-1, keepdims=True)
        heading[5] = 0.0
        ref = jpolar.features_to_polar(jnp.asarray(feats),
                                       jnp.asarray(heading))
        got = polar.features_to_polar(_t(feats), _t(heading))
        _assert_polar(got.numpy(), ref)
        return
    pts, base = _polar_inputs(rng, (30, 7))
    if fn == "polar_to_cart":
        pts[..., 1] = np.clip(pts[..., 1], -np.pi, np.pi)
    ref = getattr(jpolar, fn)(jnp.asarray(pts), jnp.asarray(base))
    got = getattr(polar, fn)(_t(pts), _t(base)).numpy()
    if fn == "cart_to_polar":
        _assert_polar(got, ref)
    else:   # Cartesian output: the angle error times r (|r| ≲ 12 here)
        ref = np.asarray(ref)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3)


@pytest.fixture(scope="module")
def gc_crop(tmp_path_factory):
    """A data config over two crops of the committed GC scene."""
    base = tmp_path_factory.mktemp("gc_crop")
    src = Scene.load(SOURCE, device="cpu")
    lines = []
    for split, (a, b) in dict(train=(0, 60), valid=(60, 90)).items():
        path = str(base / f"{split}.npy")
        crop(src, a, b, list(range(40))).save(path)
        lines.append(f"{split}:\n  - {path}\n")
    config = base / "data.yaml"
    config.write_text("".join(lines))
    return str(config)


def _datasets(config, polar):
    cfg_kw = dict(model="pinnsf_bm", dataset_name="gc2344", skip_frames=5,
                  training_mode="polar" if polar else "normal")
    jds = JaxPointwiseDataset(polar=polar)
    jds.load_data(config)
    jcfg = jds.build_dataset(JaxConfig(**cfg_kw))
    ds = PointwiseDataset(polar=polar, device="cpu")
    ds.load_data(config)
    cfg = ds.build_dataset(PIMLConfig(**cfg_kw))
    assert (cfg.ped_feature_dim, cfg.obs_feature_dim) == \
        (jcfg.ped_feature_dim, jcfg.obs_feature_dim)
    return jds, ds


def test_polar_pointwise_dataset_matches_jax(gc_crop):
    """``PointwiseDataset(polar=True)``: the neighbour features in each
    agent's heading frame, as ``test_pointwise_dataset_matches_jax``
    holds the Cartesian ones: radii to atol 1e-5 (the Cartesian features'
    tolerance), angles to atol 1e-4 but for collinear sign flips
    (``_assert_polar``).  Rows whose Cartesian obstacle features hold a
    near-tie or threshold flip (``assert_features_match`` names them) are
    left out of the obstacle comparison."""
    jds, ds = _datasets(gc_crop, polar=True)
    jcart, cart = _datasets(gc_crop, polar=False)
    flips = 0
    for split in ("train_data", "valid_data"):
        got, ref = getattr(ds, split), getattr(jds, split)
        assert len(got) == len(ref) > 0
        flips += _assert_polar(got.ped_features.numpy(), ref.ped_features,
                               r_atol=1e-5, collinear_ok=True)
        named = assert_features_match(
            getattr(jcart, split).obs_features,
            getattr(cart, split).obs_features.numpy(), 4.0,
            name=f"gc/{split}/obs")
        rows = np.ones(len(got), bool)
        rows[[r[0] for r in named]] = False
        flips += _assert_polar(got.obs_features.numpy()[rows],
                               np.asarray(ref.obs_features)[rows],
                               r_atol=1e-5, collinear_ok=True)
        np.testing.assert_allclose(got.labels.numpy(), np.asarray(ref.labels),
                                   atol=1e-5)
        np.testing.assert_allclose(got.self_features.numpy(),
                                   np.asarray(ref.self_features), atol=1e-5)
    print(f"collinear sign flips: {flips}")
    assert np.any(np.asarray(ds.train_data.ped_features[..., 1]) != 0)


# ---------------------------------------------------------------------------
# routes and schedules
# ---------------------------------------------------------------------------

def test_route_matches_jax(rng):
    _, circle, entries = gen.scenarios.gc_geometry()
    for _ in range(20):
        o_e, d_e = rng.choice(len(entries), 2, replace=False)
        od = np.stack([entries[o_e][rng.randint(100)],
                       entries[d_e][rng.randint(100)]]) + rng.rand(2, 2)
        np.testing.assert_array_equal(gen.route(od, circle),
                                      jgen.route(od, circle))


@pytest.mark.parametrize("name", sorted(gen.SCENARIOS))
def test_scenario_schedules_match_jax_bitwise(name):
    ref, ref_obs = jgen.SCENARIOS[name](30, seed=7)
    got, got_obs = gen.SCENARIOS[name](30, seed=7, device="cpu")
    for field, r, g in zip(ref._fields, ref, got):
        r = np.asarray(r)
        assert g.numpy().dtype == r.dtype, field
        np.testing.assert_array_equal(g.numpy(), r, err_msg=field)
    np.testing.assert_array_equal(got_obs, ref_obs)


# ---------------------------------------------------------------------------
# force laws and simulators
# ---------------------------------------------------------------------------

def test_social_force_matches_jax(rng):
    """A GC frame with NaN (inactive) slots and zero velocities."""
    wall, circle, _ = gen.scenarios.gc_geometry()
    obstacles = np.concatenate([wall, circle]).astype(np.float32)
    n = 60
    p = (rng.rand(n, 2) * [30, 35]).astype(np.float32)
    p[rng.rand(n) < 0.2] = np.nan
    v = rng.randn(n, 2).astype(np.float32)
    v[::7] = 0.0
    dest = (rng.rand(n, 2) * [30, 35]).astype(np.float32)
    ds = (1.34 + 0.2 * rng.randn(n)).astype(np.float32)
    args = (p, v, dest, ds, obstacles)
    ref = jgen.social_force(jgen.SFParams(), *(jnp.asarray(a) for a in args))
    got = gen.social_force(gen.SFParams(), *(_t(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    assert np.isfinite(got.numpy()[~np.isnan(p[:, 0])]).all()


@pytest.mark.parametrize("name", ["crosswalk", "GC"])
def test_simulate_matches_jax(name):
    frames = 20
    jsched, obs = jgen.SCENARIOS[name](frames, seed=666)
    sched, _ = gen.SCENARIOS[name](frames, seed=666, device="cpu")
    jps, _, jact = jgen.simulate(jgen.SFParams(), jsched, jnp.asarray(obs),
                                 frames)
    ps, _, act = gen.simulate(gen.SFParams(), sched, obs, frames,
                              device="cpu")
    np.testing.assert_array_equal(act.numpy(), np.asarray(jact))
    np.testing.assert_array_equal(np.isnan(ps.numpy()), np.isnan(jps))
    np.testing.assert_allclose(ps.numpy(), np.asarray(jps), rtol=0,
                               atol=1e-4)
    assert act.numpy()[-1].sum() > 10


def _mlapm_params(case):
    return {"raw": dict(version="raw", A=4.0, B=-2.0),
            "GC": dict(version="GC"),
            "UCY": dict(version="UCY", tau=5 / 6, A=10.67, B=-3.33, C=0.0,
                        D=0.0, theta=10.0, ucy_gate_compat=True),
            "UCY-intent": dict(version="UCY", tau=5 / 6, A=10.67, B=-3.33,
                               C=0.0, D=0.0, theta=10.0,
                               ucy_gate_compat=False)}[case]


@pytest.mark.parametrize("case", ["raw", "GC", "UCY", "UCY-intent"])
def test_mlapm_force_matches_jax(rng, case):
    n = 40
    p = (rng.rand(n, 2) * 8).astype(np.float32)
    p[rng.rand(n) < 0.15] = np.nan
    v = rng.randn(n, 2).astype(np.float32)
    v[::9] = 0.0
    ds = (1.3 + 0.2 * rng.rand(n, 1)).astype(np.float32)
    dest = (rng.rand(n, 2) * 8).astype(np.float32)
    kw = _mlapm_params(case)
    args = (p, v, ds, dest)
    ref = jmlapm.mlapm_force(jmlapm.MLAPMParams(**kw),
                             *(jnp.asarray(a) for a in args))
    got = mlapm.mlapm_force(mlapm.MLAPMParams(**kw), *(_t(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    step = mlapm.mlapm_step(mlapm.MLAPMParams(**kw), *(_t(a) for a in args),
                            0.08)
    np.testing.assert_array_equal(step.numpy(), v + got.numpy() * 0.08)


def test_simulate_mlapm_matches_jax():
    frames = 20
    jsched, _ = jgen.SCENARIOS["GC"](frames, seed=666)
    sched, _ = gen.SCENARIOS["GC"](frames, seed=666, device="cpu")
    jps, jvs, jact = jgen.simulate_mlapm(jmlapm.MLAPMParams.gc_paper(),
                                         jsched, frames)
    ps, vs, act = gen.simulate_mlapm(mlapm.MLAPMParams.gc_paper(), sched,
                                     frames, device="cpu")
    np.testing.assert_array_equal(act.numpy(), np.asarray(jact))
    np.testing.assert_array_equal(np.isnan(ps.numpy()), np.isnan(jps))
    np.testing.assert_allclose(ps.numpy(), np.asarray(jps), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(vs.numpy(), np.asarray(jvs), rtol=0,
                               atol=1e-3)


def test_circle_demo_matches_jax_with_its_v0():
    """The JAX demo's initial velocities come from ``jax.random``; the
    port takes them as ``v0``."""
    v0 = np.array(jax.random.uniform(jax.random.PRNGKey(0), (7, 2)))
    jps, jalive = jgen.circle_demo(num_frames=200)
    ps, alive = gen.circle_demo(num_frames=200, v0=torch.from_numpy(v0),
                                device="cpu")
    np.testing.assert_array_equal(alive.numpy(), np.asarray(jalive))
    np.testing.assert_array_equal(np.isnan(ps.numpy()), np.isnan(jps))
    np.testing.assert_allclose(ps.numpy(), np.asarray(jps), rtol=0,
                               atol=1e-4)
    assert alive.numpy()[-1].sum() == 0      # everyone reached the antipode
    again, _ = gen.circle_demo(num_frames=5, device="cpu")
    seeded, _ = gen.circle_demo(num_frames=5, device="cpu")
    assert torch.equal(torch.nan_to_num(again), torch.nan_to_num(seeded))


def test_to_scene_matches_jax_and_round_trips(tmp_path):
    """The same generator run packaged by both packages; then the port's
    own run through ``Scene.save`` / ``Scene.load``."""
    frames = 20
    params = jgen.SFParams()
    jsched, obs = jgen.SCENARIOS["crosswalk"](frames, seed=2)
    jps, _, jact = jgen.simulate(params, jsched, jnp.asarray(obs), frames)
    ref = jgen.to_scene(params, jsched, obs, jps, jact)
    sched, _ = gen.SCENARIOS["crosswalk"](frames, seed=2, device="cpu")
    got = gen.to_scene(gen.SFParams(), sched, obs, _t(jps), _t(jact),
                       device="cpu")
    assert got.num_pedestrians == ref.num_pedestrians > 0
    for key in SCENE_FIELDS:
        np.testing.assert_array_equal(getattr(got, key).numpy(),
                                      np.asarray(getattr(ref, key)),
                                      err_msg=key)
    ps, _, act = gen.simulate(gen.SFParams(), sched, obs, frames,
                              device="cpu")
    scene = gen.to_scene(gen.SFParams(), sched, obs, ps, act, device="cpu")
    path = str(tmp_path / "gen.npy")
    scene.save(path)
    back = Scene.load(path, device="cpu")
    # the v2.2 file keeps the waypoints reached in the scene: the
    # waypoint table and dest_num come back in that reduced form
    for key in set(SCENE_FIELDS) - {"waypoints", "dest_num"}:
        assert torch.equal(torch.nan_to_num(getattr(back, key), 7.0),
                           torch.nan_to_num(getattr(scene, key), 7.0)), key
    assert back.meta_data["source"] == "piml_tpu_torch.gen.socialforce"


def test_regenerate_scene_matches_jax(tmp_path):
    mp = dict(version="GC", A=9.30, B=-3.00, C=0.1, D=-0.2, theta=10.4)
    ref = jiterate.regenerate_scene(jmlapm.MLAPMParams(**mp), "GC", 30,
                                    str(tmp_path / "jax.npy"), seed=1000)
    got = iterate.regenerate_scene(mlapm.MLAPMParams(**mp), "GC", 30,
                                   str(tmp_path / "port.npy"), seed=1000,
                                   device="cpu")
    a = Scene.load(got, device="cpu")
    b = JaxScene.load(ref)
    np.testing.assert_array_equal(a.mask_p.numpy(), np.asarray(b.mask_p))
    np.testing.assert_allclose(a.position.numpy(), np.asarray(b.position),
                               rtol=0, atol=1e-4)
    assert a.meta_data["A"] == 9.30 and a.num_pedestrians >= 20


def test_regenerate_scene_refuses_a_degenerate_law(tmp_path):
    """B > 0: the repulsion grows with distance and every agent blows up
    within a frame of spawning, in both packages."""
    kw = dict(version="GC", A=50.0, B=3.0, C=0.0, D=0.0, theta=10.0)
    for regen, params, extra in (
            (jiterate.regenerate_scene, jmlapm.MLAPMParams, {}),
            (iterate.regenerate_scene, mlapm.MLAPMParams, {"device": "cpu"})):
        out = tmp_path / f"{params.__module__}.npy"
        with pytest.raises(ValueError, match="degenerate"):
            regen(params(**kw), "GC", 30, str(out), seed=5, **extra)
        assert not out.exists()


def test_mlapm_params_presets_match_jax():
    for name in ("gc_paper", "gc2344_v2", "ucy_v0"):
        assert dataclasses.asdict(getattr(mlapm.MLAPMParams, name)()) == \
            dataclasses.asdict(getattr(jmlapm.MLAPMParams, name)())

"""The port's symbolic-regression slice against the JAX package (CPU):
message extraction with the committed ``pinnsf_bm`` weights, the numpy
filters and fits, one loop turn (``run_iteration``), and the closed loop
(``piml_loop``) on its own.

Tolerances:
- extraction: the same kept rows; features and labels rtol 1e-4, angles
  atol 1e-4 (the acos clamp at ±(1 − 1e-6) amplifies a 1-ulp cosine
  difference up to ~700×);
- filters and fits: bitwise, the same numpy code on the same arrays;
- ``run_iteration`` from the same initial weights, dropout 0: the best
  validation loss to rtol 1e-4; the port's fits of the JAX-extracted
  arrays equal to the JAX fits bitwise.  The fits of the two extractions
  are not compared: ``post_filter``'s histogram can move a row across a
  bin edge.
"""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax.serialization import msgpack_restore

import _torch_compare  # noqa: F401  (shares the cores between workers)
import piml_tpu.sr as jsr
from piml_tpu import gen as jgen
from piml_tpu.config import PIMLConfig as JaxConfig
from piml_tpu.data import PointwiseDataset as JaxPointwiseDataset
from piml_tpu.data import make_time_indexed as jax_make_time_indexed
from piml_tpu.data import views as jviews
from piml_tpu.exp import iterate as jiterate
from piml_tpu.models import ModelSpec as JaxSpec, build_model as jax_build
from piml_tpu.train import Trainer as JaxTrainer
from piml_tpu.utils import MetricLogger as JaxLogger
from piml_tpu_torch import gen, sr
from piml_tpu_torch.config import PIMLConfig
from piml_tpu_torch.data import PointwiseData, PointwiseDataset
from piml_tpu_torch.exp import iterate
from piml_tpu_torch.models import ModelSpec, build_model, params_from_flax
from piml_tpu_torch.scene import Scene, crop
from piml_tpu_torch.sr import fit as tfit
from piml_tpu_torch.sr import gp as tgp
from piml_tpu_torch.train.trainer import Trainer
from piml_tpu_torch.utils import MetricLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MSGPACK = os.path.join(REPO, "bench_fixtures",
                       "pinnsf_bm_gc_finetuned.msgpack")
CFG = dict(model="pinnsf_bm", dataset_name="gc2344", skip_frames=5,
           dropout=0.0)
TINY = dict(CFG, batch_size=64, encoder_hidden_size=32,
            processor_hidden_size=32, decoder_hidden_size=16,
            processor_hidden_layers=2, learning_rate=1e-3, epochs=2,
            patience=5, ft_patience=5, pinnsf_interaction="loss",
            exp_name="loop", model_name_suffix="t")


def _quiet(cls=MetricLogger):
    return cls(stream=open(os.devnull, "w"))


def _port_rows(jrows) -> PointwiseData:
    return PointwiseData(
        **{k: torch.from_numpy(np.array(getattr(jrows, k)))
           for k in ("ped_features", "obs_features", "self_features",
                     "labels")},
        meta_data=dict(jrows.meta_data))


@pytest.fixture(scope="module")
def crosswalk(tmp_path_factory):
    """A 40-frame social-force crosswalk scene (the JAX generator), and
    both packages' pointwise rows of its first 20 frames, Cartesian and
    polar."""
    from piml_tpu.scene import Scene as JaxScene

    base = tmp_path_factory.mktemp("crosswalk")
    sched, obs = jgen.SCENARIOS["crosswalk"](40, seed=666)
    ps, _, act = jgen.simulate(jgen.SFParams(), sched, jnp.asarray(obs), 40)
    path = str(base / "crosswalk.npy")
    jgen.to_scene(jgen.SFParams(), sched, obs, ps, act).save(path)
    scene = Scene.load(path, device="cpu")
    first = str(base / "first20.npy")
    crop(scene, 0, 20).save(first)
    rows = {}
    for polar in (False, True):
        rows[polar] = jviews.to_pointwise(jax_make_time_indexed(
            JaxConfig(**CFG), JaxScene.load(first), polar=polar))
    return dict(scene=scene, rows=rows)


@pytest.fixture(scope="module")
def models():
    with open(MSGPACK, "rb") as f:
        params = msgpack_restore(f.read())
    jmodel = jax_build(JaxSpec.from_config(JaxConfig(**CFG)))

    def apply_fn(p, pf, of, sf):
        return jmodel.apply(p, pf, of, sf)

    model = build_model(ModelSpec.from_config(PIMLConfig(**CFG)))
    model.load_state_dict(params_from_flax(params))
    return params, apply_fn, model


# ---------------------------------------------------------------------------
# extraction
# ---------------------------------------------------------------------------

def _close(got, ref, angle_cols, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    other = [c for c in range(got.shape[1]) if c not in angle_cols]
    np.testing.assert_allclose(got[:, other], ref[:, other], rtol=1e-4,
                               atol=1e-6, err_msg=what)
    np.testing.assert_allclose(got[:, angle_cols], ref[:, angle_cols],
                               rtol=0, atol=1e-4, err_msg=what)


def test_prepare_symbolic_regression_data_matches_jax(crosswalk, models):
    params, apply_fn, model = models
    jrows = crosswalk["rows"][False]
    ref_f, ref_l = jsr.prepare_symbolic_regression_data(params, apply_fn,
                                                         jrows)
    got_f, got_l = sr.prepare_symbolic_regression_data(model,
                                                        _port_rows(jrows))
    assert got_f.shape[0] == ref_f.shape[0] > 100    # in-threshold pairs
    # the keep mask: raw rows with a neighbour (r > 0)
    assert (got_f[:, 0] > 0).all()
    _close(got_f, ref_f, [1, 3, 4], "features")
    _close(got_l, ref_l, [1], "labels")
    assert got_f.dtype == ref_f.dtype and got_l.dtype == ref_l.dtype


def test_prepare_vector_regression_data_matches_jax(crosswalk, models):
    params, apply_fn, model = models
    jrows = crosswalk["rows"][False]
    ref = jsr.prepare_vector_regression_data(params, apply_fn, jrows)
    got = sr.prepare_vector_regression_data(model, _port_rows(jrows))
    for g, r, what in zip(got, ref, ("dr", "dv", "F")):
        assert g.shape == r.shape and g.shape[0] > 100, what
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-6, err_msg=what)


def test_prepare_symbolic_regression_data_polar_matches_jax(crosswalk,
                                                            models):
    params, apply_fn, model = models
    jrows = crosswalk["rows"][True]
    ref = jsr.prepare_symbolic_regression_data_polar(params, apply_fn, jrows)
    got = sr.prepare_symbolic_regression_data_polar(model, _port_rows(jrows))
    assert got[0].shape == ref[0].shape and got[0].shape[0] > 100
    _close(got[0], ref[0], [1, 3], "polar features")
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-4, atol=1e-6)


def _zoo_model(name):
    """``name`` at small widths: the JAX model with a flax tree
    initialised here, its ``apply``, and the port's model on that tree."""
    kw = dict(name=name, encoder_hidden_size=16, processor_hidden_size=16,
              decoder_hidden_size=8, processor_hidden_layers=2, dropout=0.0)
    jmodel = jax_build(JaxSpec(**kw))
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(4), np.zeros((1, 6, 6), np.float32),
        np.zeros((1, 10, 6), np.float32), np.ones((1, 7), np.float32)))
    model = build_model(ModelSpec(**kw))
    model.load_state_dict(params_from_flax(params), strict=True)
    return params, jax.jit(jmodel.apply), model


def test_prepare_symbolic_regression_data_pinnsf_m_matches_jax(crosswalk):
    """The non-bottleneck branch: ``pinnsf_m``'s messages are processor
    embeddings, and the labels are their columns by falling variance."""
    params, apply_fn, model = _zoo_model("pinnsf_m")
    jrows = crosswalk["rows"][False]
    ref_f, ref_l = jsr.prepare_symbolic_regression_data(params, apply_fn,
                                                         jrows)
    got_f, got_l = sr.prepare_symbolic_regression_data(model,
                                                        _port_rows(jrows))
    assert got_l.shape == ref_l.shape and got_l.shape[1] == 16
    assert got_f.shape[0] > 100
    std = got_l.std(axis=0)
    assert np.all(std[:-1] >= std[1:])
    _close(got_f, ref_f, [1, 3, 4], "features")
    _close(got_l, ref_l, [], "labels")


def test_prepare_symbolic_regression_data_polar_pinnsf_pb_matches_jax(
        crosswalk):
    """The polar extraction with the per-edge polar bottleneck model."""
    params, apply_fn, model = _zoo_model("pinnsf_pb")
    jrows = crosswalk["rows"][True]
    ref = jsr.prepare_symbolic_regression_data_polar(params, apply_fn, jrows)
    got = sr.prepare_symbolic_regression_data_polar(model, _port_rows(jrows))
    assert got[1].shape == ref[1].shape and got[1].shape[1] == 2
    assert got[0].shape[0] > 100
    _close(got[0], ref[0], [1, 3], "polar features")
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-4, atol=1e-6)


def test_extraction_chunks_give_the_same_result(crosswalk, models,
                                                monkeypatch):
    from piml_tpu_torch.sr import extract

    _, _, model = models
    rows = _port_rows(crosswalk["rows"][False])
    whole = sr.prepare_symbolic_regression_data(model, rows)
    monkeypatch.setattr(extract, "EXTRACT_CHUNK", 37)
    chunked = sr.prepare_symbolic_regression_data(model, rows)
    for a, b in zip(whole, chunked):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# filters and fits: the same numpy code
# ---------------------------------------------------------------------------

def _fit_inputs():
    rng = np.random.RandomState(5)
    n = 3000
    r = rng.uniform(0.2, 4.0, n)
    cos = rng.uniform(-1, 1, n)
    mag = 9.3 * np.exp(-3.0 * r + 0.1 * cos - 0.2 * r * cos)
    mag = mag * (1 + 0.02 * rng.randn(n)) + 1e-3 * rng.rand(n)
    dr = rng.randn(n, 2) * 1.5
    dv = rng.randn(n, 2)
    law = tfit.VectorForceLawFit(9.3, -3.0, 0.1, -0.2, 10.4, 0.0)
    force = law.force(dr, dv) + 1e-3 * rng.randn(n, 2)
    feats = np.stack([r, rng.uniform(-3, 3, n), rng.rand(n),
                      rng.uniform(-3, 3, n), rng.uniform(-3, 3, n),
                      rng.randint(0, 2, n)], 1)
    labels = np.stack([mag, rng.uniform(-3, 3, n)], 1)
    return dict(r=r, cos=cos, mag=mag, dr=dr, dv=dv, force=force,
                feats=feats, labels=labels)


def _run_fit(pkg, name, d):
    """``pkg`` is (sr, fit, gp) of one package."""
    srm, fitm, gpm = pkg
    if name == "post_filter":
        return srm.post_filter(d["feats"], d["labels"][:, 0], seed=3)
    if name == "direction_filter":
        return srm.direction_filter(d["feats"], d["labels"])
    if name == "fit_force_law":
        return dataclasses.astuple(fitm.fit_force_law(d["r"], d["cos"],
                                                      d["mag"]))
    if name == "fit_force_law_mse":
        seed = fitm.fit_force_law(d["r"], d["cos"], d["mag"])
        return dataclasses.astuple(fitm.fit_force_law_mse(
            d["r"], d["cos"], d["mag"], init=seed))
    if name == "fit_vector_force_law":
        return dataclasses.astuple(fitm.fit_vector_force_law(
            d["dr"], d["dv"], d["force"]))
    if name == "fit_direction_bias":
        return fitm.fit_direction_bias(d["labels"][:, 1], d["feats"][:, 1])
    model = gpm.GPSymbolicRegressor(populations=2, niterations=2,
                                    evolutions_per_iteration=60,
                                    batch_size=256, seed=1)
    model.fit(np.stack([d["r"], d["cos"]], 1)[:800], d["mag"][:800])
    return [(e.complexity, e.loss, e.score, e.expression)
            for e in model.equations_]


@pytest.mark.parametrize("name", [
    "post_filter", "direction_filter", "fit_force_law", "fit_force_law_mse",
    "fit_vector_force_law", "fit_direction_bias", "GPSymbolicRegressor"])
def test_filters_and_fits_equal_jax_bitwise(name):
    from piml_tpu.sr import fit as jfit
    from piml_tpu.sr import gp as jgp

    d = _fit_inputs()
    got = _run_fit((sr, tfit, tgp), name, d)
    ref = _run_fit((jsr, jfit, jgp), name, d)
    if isinstance(got, tuple) and isinstance(got[0], np.ndarray):
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
    else:
        assert got == ref
    if name == "fit_vector_force_law":    # and it recovers the law
        assert got[0] == pytest.approx(9.3, rel=1e-2)
        assert got[4] == pytest.approx(10.4, abs=0.1)


# ---------------------------------------------------------------------------
# one loop turn, and the closed loop
# ---------------------------------------------------------------------------

def _loop_config(scene: Scene, base, frames):
    """Train / valid crops of a scene and their data config."""
    split = int(frames * 0.7)
    lines = []
    for name, (a, b) in dict(train=(0, split), valid=(split, frames)).items():
        path = str(base / f"{name}.npy")
        crop(scene, a, b).save(path)
        lines.append(f"{name}:\n  - {path}\n")
    config = base / "data.yaml"
    config.write_text("".join(lines))
    return str(config)


def test_run_iteration_matches_jax(crosswalk, tmp_path, monkeypatch):
    """Train → extract → fit, both packages from the JAX package's
    initial weights on the same rows."""
    config = _loop_config(crosswalk["scene"], tmp_path, 40)
    jds = JaxPointwiseDataset()
    jds.load_data(config)
    jcfg = jds.build_dataset(JaxConfig(**TINY,
                                       save_dir=str(tmp_path / "jax")))
    extracted = {}

    def record(key, fn):
        def wrapped(*args):
            extracted[key] = fn(*args)
            return extracted[key]
        return wrapped

    monkeypatch.setattr(jiterate, "prepare_symbolic_regression_data",
                        record("sr", jsr.prepare_symbolic_regression_data))
    monkeypatch.setattr(jsr, "prepare_vector_regression_data",
                        record("vec", jsr.prepare_vector_regression_data))
    ref, _ = jiterate.run_iteration(jcfg, jds, _quiet(JaxLogger),
                                    vector_fit=True)
    jparams = JaxTrainer(jcfg, _quiet(JaxLogger)).init_params(jds.train_data)

    init = Trainer.init_params

    def init_from_jax(self, sample):
        init(self, sample)
        self.model.load_state_dict(params_from_flax(
            jax.tree_util.tree_map(np.asarray, jparams)))
        return self.model.state_dict()

    monkeypatch.setattr(Trainer, "init_params", init_from_jax)
    ds = PointwiseDataset(device="cpu")
    ds.train_data = _port_rows(jds.train_data)
    ds.valid_data = _port_rows(jds.valid_data)
    cfg = PIMLConfig(**{**TINY, "save_dir": str(tmp_path / "t"),
                        "ped_feature_dim": jcfg.ped_feature_dim,
                        "obs_feature_dim": jcfg.obs_feature_dim,
                        "self_feature_dim": jcfg.self_feature_dim,
                        "time_unit": jcfg.time_unit})
    logger = _quiet()
    got, params = iterate.run_iteration(cfg, ds, logger, vector_fit=True)
    assert got.val_loss == pytest.approx(ref.val_loss, rel=1e-4)
    assert got.iteration == ref.iteration == 1
    assert all(math.isfinite(v) for v in (got.fit_A, got.fit_B, got.vec_A,
                                          got.vec_theta_deg))
    assert set(params) == set(Trainer(cfg).init_params(ds.train_data))
    timing = [r for r in logger.records if "extract_edges" in r]
    assert timing and timing[0]["extract_edges"] > 0

    # the port's fits of the JAX-extracted arrays: the JAX fits, bitwise
    fields = iterate.fit_extracted(*extracted["sr"], jcfg.seed,
                                   extracted["vec"])
    for key, value in fields.items():
        assert value == getattr(ref, key), key
    assert set(fields) >= {"fit_A", "fit_r2", "vec_A", "vec_theta_deg"}
    mp = iterate.IterationResult(iteration=0, val_loss=0.0,
                                 **fields).mlapm_params()
    assert (mp.A, mp.theta) == (ref.vec_A, ref.vec_theta_deg)


def test_piml_loop_closes_on_the_cpu(tmp_path, monkeypatch):
    """Two iterations on a generated crosswalk scene, the second on scenes
    regenerated from the first's fitted law."""
    frames = 60
    sched, obs = gen.SCENARIOS["crosswalk"](frames, seed=666, device="cpu")
    ps, _, act = gen.simulate(gen.SFParams(), sched, obs, frames,
                              device="cpu")
    scene = gen.to_scene(gen.SFParams(), sched, obs, ps, act, device="cpu")
    config = _loop_config(scene, tmp_path, frames)
    seen = []
    run = iterate.run_iteration

    def spy(cfg, *args, **kw):
        seen.append(cfg.iter_flag)
        return run(cfg, *args, **kw)

    monkeypatch.setattr(iterate, "run_iteration", spy)
    cfg = PIMLConfig(**{**TINY, "save_dir": str(tmp_path / "ck")})
    logger = _quiet()
    results = iterate.piml_loop(cfg, config, iterations=2, logger=logger,
                                regen_scenario="crosswalk",
                                regen_frames=frames,
                                work_dir=str(tmp_path), vector_fit=True,
                                device="cpu")
    assert seen == [False, True]
    assert [r.iteration for r in results] == [0, 1]
    for r in results:
        assert all(math.isfinite(v) for v in (
            r.val_loss, r.fit_A, r.fit_B, r.fit_C, r.fit_D, r.vec_A,
            r.vec_B, r.vec_theta_deg))
    with open(tmp_path / "regen_iter0.yaml") as f:
        written = yaml.safe_load(f)
    assert set(written) == {"train", "valid"}
    for paths in written.values():
        regen = Scene.load(paths[0], device="cpu")
        assert regen.num_steps == frames and regen.num_pedestrians > 10
        assert regen.meta_data["A"] == results[0].vec_A
    assert [r["regen_s"] > 0 for r in logger.records if "regen_s" in r] \
        == [True]
    for it in (0, 1):
        assert os.path.isfile(tmp_path / "ck" / f"loop_t_iter{it}")

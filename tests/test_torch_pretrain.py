"""The port's pretrain path against the JAX package (CPU): analytic forces,
scene augmentation and I/O, pointwise views, dataset orchestration, the
pretrain loss and the pretrain loop; then the port's resume and its CLI
pipeline on their own.

A small ``pinnsf_bm`` (two processor layers, widths 32) trains on a tiny
scene: the 40 first agents over frames 0-80 of the committed GC scene,
cropped and written with the port's ``Scene.save``; both packages load the
same file.

Tolerances:
- views, datasets: the same gathers of features that agree to atol 1e-5
  (as ``tests/test_torch_engine.py``); the row filter is exact;
- forces: rtol 1e-5;
- the pretrain loss: rtol 1e-5, gradients to relative L2 1e-4 per tensor;
- two pretrain epochs from the same weights, dropout 0: per-epoch
  validation loss to rtol 1e-4, final parameters to relative L2 1e-4 per
  tensor;
- a resumed run: bit for bit.
"""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_compare  # noqa: F401  (shares the cores between workers)
from piml_tpu.config import PIMLConfig as JaxConfig
from piml_tpu.data import FinetuneDataset as JaxFinetuneDataset
from piml_tpu.data import PointwiseDataset as JaxPointwiseDataset
from piml_tpu.data import make_time_indexed as jax_make_time_indexed
from piml_tpu.data import views as jviews
from piml_tpu.physics import forces as jforces
from piml_tpu.scene import Scene as JaxScene
from piml_tpu.scene import mirror as jax_mirror
from piml_tpu.scene import rotate as jax_rotate
from piml_tpu.train import Trainer as JaxTrainer
from piml_tpu.utils import MetricLogger as JaxLogger
from piml_tpu_torch.config import PIMLConfig
from piml_tpu_torch.data import (FinetuneDataset, PointwiseDataset,
                                 TimeIndexedData, merge_pointwise, pad_agents,
                                 slice_frames, split_train_val_test,
                                 to_pointwise)
from piml_tpu_torch.exp import main as exp_main
from piml_tpu_torch.models import params_from_flax
from piml_tpu_torch.models.blocks import dropout
from piml_tpu_torch.physics import forces
from piml_tpu_torch.scene import (Scene, crop, mirror, random_walk_noise,
                                  rotate)
from piml_tpu_torch.train import checkpoint as ckpt
from piml_tpu_torch.train.trainer import Trainer, checkpoint_path
from piml_tpu_torch.utils import MetricLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "repro_work", "gc_sf_repro.npy")
AGENTS = list(range(40))
CFG = dict(model="pinnsf_bm", dataset_name="gc2344", skip_frames=5,
           valid_steps=5, dropout=0.0, batch_size=64, ft_batch_size=8,
           encoder_hidden_size=32, processor_hidden_size=32,
           decoder_hidden_size=32, processor_hidden_layers=2,
           learning_rate=2e-4, weight_decay=1e-6, collision_pred_weight=5e-2,
           reg_weight=1e-2, exp_name="tiny", model_name_suffix="t")
SCENE_FIELDS = ("position", "velocity", "acceleration", "destination",
                "waypoints", "dest_idx", "dest_num", "obstacles", "mask_p",
                "mask_v", "mask_a")


def _quiet(cls=MetricLogger):
    return cls(stream=open(os.devnull, "w"))


class _Records(JaxLogger):
    """The JAX package's logger, keeping its records."""

    def __init__(self):
        super().__init__(stream=open(os.devnull, "w"))
        self.records = []

    def log(self, **metrics):
        self.records.append(metrics)


def _rel_l2(got, ref):
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def _to_port(jdata) -> TimeIndexedData:
    return TimeIndexedData(
        **{f.name: torch.from_numpy(np.array(getattr(jdata, f.name)))
           for f in dataclasses.fields(TimeIndexedData)
           if f.name != "meta_data"},
        meta_data=dict(jdata.meta_data))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """Cropped scenes on disk, a data config over them, and both
    packages' time-indexed views of the training scene."""
    base = tmp_path_factory.mktemp("tiny")
    src = Scene.load(SOURCE, device="cpu")
    paths = {}
    for split, (a, b) in dict(train=(0, 80), valid=(80, 120),
                              test=(120, 160)).items():
        paths[split] = str(base / f"{split}.npy")
        crop(src, a, b, AGENTS).save(paths[split])
    config = base / "data.yaml"
    config.write_text("".join(f"{k}:\n  - {p}\n" for k, p in paths.items()))
    jdata = jax_make_time_indexed(JaxConfig(**CFG),
                                  JaxScene.load(paths["train"]))
    return dict(base=base, paths=paths, config=str(config), jdata=jdata,
                tdata=_to_port(jdata))


# ---------------------------------------------------------------------------
# forces, scenes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dv_from_velocity", [False, True])
@pytest.mark.parametrize("version", ["v0", "v1", "v2"])
def test_pairwise_acceleration_matches_jax(rng, version, dv_from_velocity):
    rel = rng.randn(50, 6, 6).astype(np.float32) * 2.0
    ref = jforces.pairwise_acceleration(jnp.asarray(rel), version, "gc2344",
                                        dv_from_velocity=dv_from_velocity)
    got = forces.pairwise_acceleration(torch.from_numpy(rel), version,
                                       "gc2344",
                                       dv_from_velocity=dv_from_velocity)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-7)


def test_physical_pair_force_matches_jax(rng):
    rel = rng.randn(40, 2).astype(np.float32)
    rel[::7] = np.nan
    rel[3] = 0.0
    ref = jforces.physical_pair_force(jnp.asarray(rel), 2.1, 0.3)
    got = forces.physical_pair_force(torch.from_numpy(rel), 2.1, 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("fn", ["rotate", "mirror"])
def test_rotate_and_mirror_match_jax(tiny, fn):
    path = tiny["paths"]["train"]
    ref = {"rotate": jax_rotate, "mirror": jax_mirror}[fn](
        JaxScene.load(path), 37.0)
    got = {"rotate": rotate, "mirror": mirror}[fn](
        Scene.load(path, device="cpu"), 37.0)
    for key in SCENE_FIELDS:
        np.testing.assert_allclose(getattr(got, key).numpy(),
                                   np.asarray(getattr(ref, key)),
                                   rtol=1e-6, atol=1e-5, err_msg=key)


def test_scene_save_round_trip(tiny, tmp_path):
    """The port's writer gives the file the JAX package reads, and writing
    a loaded scene again changes nothing."""
    path = tiny["paths"]["train"]
    got, ref = Scene.load(path, device="cpu"), JaxScene.load(path)
    assert got.num_pedestrians == len(AGENTS) and got.num_steps == 80
    again = str(tmp_path / "again.npy")
    got.save(again)
    back = Scene.load(again, device="cpu")
    for key in SCENE_FIELDS:
        np.testing.assert_allclose(getattr(got, key).numpy(),
                                   np.asarray(getattr(ref, key)),
                                   rtol=1e-6, atol=1e-5, err_msg=key)
        assert torch.equal(torch.nan_to_num(getattr(back, key), 7.0),
                           torch.nan_to_num(getattr(got, key), 7.0)), key
    # the crop keeps the source's positions on its frames and agents
    src = Scene.load(SOURCE, device="cpu")
    live = got.mask_p == 1
    assert torch.equal(got.position[live],
                       src.position[:80, :len(AGENTS)][live])


def test_random_walk_noise_masks_and_scale():
    T, N, std = 16, 20000, 0.3
    mask = torch.ones(T, N)
    mask[:, ::5] = 0.0
    mask[10:, 1::5] = 0.0
    noise = random_walk_noise(torch.Generator().manual_seed(0),
                              torch.zeros(T, N, 2), mask, std)
    assert torch.equal(noise[mask == 0], torch.zeros_like(noise[mask == 0]))
    # cumulative steps of std / sqrt(T): the last frame has std `std`
    full = noise[-1][mask.sum(0) == T]
    assert float(full.std()) == pytest.approx(std, rel=0.03)
    again = random_walk_noise(torch.Generator().manual_seed(0),
                              torch.zeros(T, N, 2), mask, std)
    assert torch.equal(noise, again)


# ---------------------------------------------------------------------------
# views and datasets
# ---------------------------------------------------------------------------

def test_pointwise_views_match_jax(tiny):
    jd, td = tiny["jdata"], tiny["tdata"]
    frames = np.arange(10, 60)
    for kw in ({}, {"frames": frames}):
        ref = jviews.to_pointwise(jd, **kw)
        got = to_pointwise(td, **kw)
        assert len(got) == len(ref) > 0
        for key in ("ped_features", "obs_features", "self_features",
                    "labels"):
            np.testing.assert_array_equal(getattr(got, key).numpy(),
                                          np.asarray(getattr(ref, key)),
                                          err_msg=key)
    both = merge_pointwise([to_pointwise(td), to_pointwise(td, frames)])
    ref = jviews.merge_pointwise([jviews.to_pointwise(jd),
                                  jviews.to_pointwise(jd, frames)])
    np.testing.assert_array_equal(both.labels.numpy(), np.asarray(ref.labels))
    part = slice_frames(td, 20, 50)
    np.testing.assert_array_equal(
        part.position.numpy(),
        np.asarray(jviews.slice_frames(jd, 20, 50).position))
    padded = pad_agents(td, 64)
    ref = jviews.pad_agents(jd, 64)
    for f in dataclasses.fields(TimeIndexedData):
        if f.name != "meta_data":
            np.testing.assert_array_equal(getattr(padded, f.name).numpy(),
                                          np.asarray(getattr(ref, f.name)),
                                          err_msg=f.name)


def test_split_train_val_test_matches_jax():
    from piml_tpu.data.datasets import split_train_val_test as jax_split

    for shuffle in (False, True):
        got = split_train_val_test(50, 0.6, 0.2, 0.2, 3, shuffle)
        ref = jax_split(50, 0.6, 0.2, 0.2, 3, shuffle)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


def test_pointwise_dataset_matches_jax(tiny):
    jds = JaxPointwiseDataset()
    jds.load_data(tiny["config"])
    jcfg = jds.build_dataset(JaxConfig(**CFG))
    ds = PointwiseDataset(device="cpu")
    ds.load_data(tiny["config"])
    cfg = ds.build_dataset(PIMLConfig(**CFG))
    assert (cfg.ped_feature_dim, cfg.obs_feature_dim, cfg.self_feature_dim,
            cfg.time_unit) == (jcfg.ped_feature_dim, jcfg.obs_feature_dim,
                               jcfg.self_feature_dim, jcfg.time_unit)
    for split in ("train_data", "valid_data"):
        got, ref = getattr(ds, split), getattr(jds, split)
        assert len(got) == len(ref) > 0
        for key in ("self_features", "labels", "ped_features"):
            np.testing.assert_allclose(getattr(got, key).numpy(),
                                       np.asarray(getattr(ref, key)),
                                       atol=1e-5, err_msg=f"{split} {key}")
    assert len(ds.test_data) == len(jds.test_data) == 1
    assert ds.test_data[0].num_frames == jds.test_data[0].num_frames


def test_finetune_dataset_matches_jax(tiny, tmp_path):
    """Two training scenes of different agent counts: the port pads them
    to one slot count with inert agents, as the JAX package does."""
    src = Scene.load(SOURCE, device="cpu")
    small = str(tmp_path / "small.npy")
    crop(src, 0, 60, AGENTS[:25]).save(small)
    config = tmp_path / "ft.yaml"
    p = tiny["paths"]
    config.write_text(f"train:\n  - {p['train']}\n  - {small}\n"
                      f"valid:\n  - {p['valid']}\ntest:\n  - {p['test']}\n")
    jds = JaxFinetuneDataset()
    jds.load_data(str(config))
    jds.build_dataset(JaxConfig(**CFG))
    ds = FinetuneDataset(device="cpu")
    ds.load_data(str(config))
    ds.build_dataset(PIMLConfig(**CFG))
    assert len(ds.train_data) == len(jds.train_data) == 2
    for got, ref in zip(ds.train_data, jds.train_data):
        assert got.num_channels == ref.num_channels
        assert got.position.shape == tuple(ref.position.shape)
        for key in ("mask_p_pred", "dest_num", "abnormal_mask"):
            np.testing.assert_array_equal(getattr(got, key).numpy(),
                                          np.asarray(getattr(ref, key)),
                                          err_msg=key)
        for key in ("position", "labels", "self_features"):
            np.testing.assert_allclose(getattr(got, key).numpy(),
                                       np.asarray(getattr(ref, key)),
                                       atol=1e-5, err_msg=key)
    assert len(ds.valid_data) == len(ds.test_data) == 1


# ---------------------------------------------------------------------------
# the pretrain loss and loop
# ---------------------------------------------------------------------------

def _jax_trainer(cfg_kw, sample):
    trainer = JaxTrainer(JaxConfig(**cfg_kw), _quiet(JaxLogger))
    return trainer, trainer.init_params(sample)


@pytest.mark.parametrize("interaction", ["sim", "loss"])
def test_pointwise_loss_terms_match_jax(tiny, interaction):
    cfg_kw = dict(CFG, pinnsf_interaction=interaction, true_label_weight=0.5)
    jrows = jviews.to_pointwise(tiny["jdata"])
    jtrainer, jparams = _jax_trainer(cfg_kw, jrows)
    idx = np.arange(0, len(jrows), 7)[:200]
    batch = [np.asarray(getattr(jrows, k))[idx] for k in
             ("ped_features", "obs_features", "self_features", "labels")]

    def loss_fn(p):
        return jtrainer._pointwise_loss_terms(
            p, *(jnp.asarray(b) for b in batch), jax.random.PRNGKey(0))

    (ref, ref_aux), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        jparams)

    trainer = Trainer(PIMLConfig(**cfg_kw), _quiet())
    trainer.init_params(to_pointwise(tiny["tdata"]))
    trainer.model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, jparams)))
    loss, aux = trainer._pointwise_loss_terms(
        *(torch.from_numpy(b) for b in batch))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(ref), rel=1e-5)
    for g, r in zip(aux, ref_aux):
        assert float(g) == pytest.approx(float(r), rel=1e-5, abs=1e-6)
    assert float(aux[2]) > 0                       # the collision head's BCE
    gref = params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in trainer.model.named_parameters():
        err = _rel_l2(p.grad.numpy(), gref[name].numpy())
        assert err <= 1e-4, (name, err)


def test_train_pointwise_two_epochs_match_jax(tiny, tmp_path):
    """Two epochs from the same converted weights, dropout 0: the same
    batches in the same order, Adam against optax."""
    cfg_kw = dict(CFG, epochs=2, patience=5, ft_patience=5)
    jrows = jviews.to_pointwise(tiny["jdata"])
    jvalid = jviews.to_pointwise(tiny["jdata"], np.arange(40, 80))
    jtrainer, jparams = _jax_trainer(
        dict(cfg_kw, save_dir=str(tmp_path / "jax")), jrows)
    jtrainer.logger = _Records()
    ref = jtrainer.train_pointwise(jrows, jvalid, params=jparams)

    logger = MetricLogger(stream=open(os.devnull, "w"))
    trainer = Trainer(PIMLConfig(**cfg_kw, save_dir=str(tmp_path / "t")),
                      logger)
    got = trainer.train_pointwise(
        to_pointwise(tiny["tdata"]),
        to_pointwise(tiny["tdata"], np.arange(40, 80)),
        params=params_from_flax(jax.tree_util.tree_map(np.asarray, jparams)))

    def vals(records):
        return [r["val_loss"] for r in records if "val_loss" in r]

    assert len(vals(logger.records)) == len(vals(jtrainer.logger.records)) \
        == 2
    np.testing.assert_allclose(vals(logger.records),
                               vals(jtrainer.logger.records), rtol=1e-4)
    assert got.best_val == pytest.approx(ref.best_val, rel=1e-4)
    pref = params_from_flax(jax.tree_util.tree_map(np.asarray, ref.params))
    for name, p in got.params.items():
        err = _rel_l2(p.numpy(), pref[name].numpy())
        assert err <= 1e-4, (name, err)


def test_empty_validation_set_never_improves_like_jax(tiny, tmp_path):
    """No predictable validation rows: the JAX package's validation MSE
    is 0 / 0 = NaN, so no epoch improves on the initial +inf."""
    cfg_kw = dict(CFG, epochs=2, patience=5, ft_patience=5)
    jrows = jviews.to_pointwise(tiny["jdata"])
    jempty = jviews.to_pointwise(tiny["jdata"], [])
    jtrainer, jparams = _jax_trainer(
        dict(cfg_kw, save_dir=str(tmp_path / "jax")), jrows)
    ref = jtrainer.train_pointwise(jrows, jempty, params=jparams)
    got = Trainer(PIMLConfig(**cfg_kw, save_dir=str(tmp_path / "t")),
                  _quiet()).train_pointwise(
        to_pointwise(tiny["tdata"]), to_pointwise(tiny["tdata"], []))
    assert len(jempty) == 0
    assert got.best_val == ref.best_val == math.inf


def _pretrain(tiny, save_dir, epochs, resume, dropout_p=0.5):
    cfg = PIMLConfig(**{**CFG, "epochs": epochs, "resume": resume,
                        "save_dir": str(save_dir), "dropout": dropout_p,
                        "patience": 5, "ft_patience": 5})
    logger = _quiet()
    state = Trainer(cfg, logger).train_pointwise(
        to_pointwise(tiny["tdata"]),
        to_pointwise(tiny["tdata"], np.arange(40, 80)))
    return state, [r for r in logger.records if "epoch" in r], cfg


def test_resumed_pretrain_is_bit_identical(tiny, tmp_path):
    """Two epochs, then a new trainer resuming to three, equals three
    epochs in one go, bit for bit (live dropout included): the full
    training state restores and shuffling and dropout derive from
    (seed, epoch) only."""
    whole, whole_logs, _ = _pretrain(tiny, tmp_path / "a", 3, False)
    _pretrain(tiny, tmp_path / "b", 2, True)
    resumed, logs, cfg = _pretrain(tiny, tmp_path / "b", 3, True)
    assert [r["epoch"] for r in logs] == [2, 2]
    for r in logs:
        ref = [w for w in whole_logs if w["epoch"] == 2 and w.keys() == r.keys()]
        assert {k: v for k, v in r.items() if k != "time"} == \
            {k: v for k, v in ref[0].items() if k != "time"}
    assert resumed.best_val == whole.best_val
    for name, p in whole.params.items():
        assert torch.equal(resumed.params[name], p), name
    assert ckpt.latest_step(checkpoint_path(cfg, False) + "_resume") == 2


def test_checkpoint_keeps_the_newest_steps(tmp_path):
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(model.parameters())
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    for step in range(4):
        ckpt.save_train_state(str(tmp_path), step, model.state_dict(),
                              opt.state_dict(), extra={"epoch": step})
    assert sorted(os.listdir(tmp_path)) == ["step_2.pt", "step_3.pt"]
    assert ckpt.latest_step(str(tmp_path)) == 3
    back = ckpt.restore_train_state(str(tmp_path))
    assert back["extra"] == {"epoch": 3}
    assert torch.equal(back["params"]["weight"], model.weight.detach())
    opt2 = torch.optim.Adam(model.parameters())
    opt2.load_state_dict(back["opt_state"])
    assert torch.equal(opt2.state_dict()["state"][0]["exp_avg"],
                       opt.state_dict()["state"][0]["exp_avg"])
    assert ckpt.restore_train_state(str(tmp_path / "none")) is None


def test_dropout_with_one_generator():
    x = torch.ones(64, 6, 32)
    a = dropout(x, 0.5, torch.Generator().manual_seed(3))
    b = dropout(x, 0.5, torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and torch.all((a == 0) | (a == 2.0))
    assert abs((a > 0).double().mean().item() - 0.5) < 0.02


# ---------------------------------------------------------------------------
# the CLI pipeline
# ---------------------------------------------------------------------------

def test_run_end_to_end_on_cpu(tiny, tmp_path):
    """Pretrain, test, finetune, test; then a resumed rerun with one more
    epoch starts both loops at epoch 2."""
    jsonl = str(tmp_path / "metrics.jsonl")
    cfg = PIMLConfig(**{**CFG, "epochs": 2, "dropout": 0.5, "shuffle": True,
                        "finetune_flag": True, "resume": True,
                        "patience": 5, "ft_patience": 5,
                        "data_config": tiny["config"],
                        "ft_data_config": tiny["config"],
                        "save_dir": str(tmp_path / "ck")})
    logger = MetricLogger(jsonl_path=jsonl, stream=open(os.devnull, "w"))
    results = exp_main.run(cfg, logger, device="cpu")
    logger.close()
    assert set(results) == {"pretrain_val", "pretrain_test_mae",
                            "finetune_val", "train_time_s"}
    assert all(math.isfinite(v) for v in results.values())
    tests = [r for r in logger.records if "test_ot" in r]
    assert len(tests) == 2
    for r in tests:
        assert all(math.isfinite(r[k]) for k in ("test_mae", "test_ot",
                                                 "test_mmd", "test_loss"))
        assert r["test_ot"] > 0 and r["test_mmd"] > 0
    losses = [r[k] for r in logger.records for k in r if "loss" in k]
    assert losses and all(math.isfinite(v) for v in losses)
    for finetuned in (False, True):
        path = checkpoint_path(cfg, finetuned)
        assert os.path.isfile(path)
        assert ckpt.latest_step(path + "_resume") == 1
    with open(jsonl) as f:
        assert sum(1 for _ in f) == len(logger.records)

    again = _quiet()
    exp_main.run(cfg.replace(epochs=3), again, device="cpu")
    epochs = [r["epoch"] for r in again.records if "train_loss" in r]
    assert epochs == [2, 2]


def test_main_refuses_to_run_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        exp_main.main(["--epochs", "1"])

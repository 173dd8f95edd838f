"""The port's finetune path against the JAX package (CPU): windowed views,
batches, losses, Adam, dropout, the differentiable training loss and the
trainer.

Tolerances:
- views, batches: exact (the same gathers of the same numbers);
- loss functions: rtol 1e-6 (float32, other summation orders);
- one Adam step from identical gradients: params to 1e-6; three steps
  of the per-group finetune Adam against ``optax.multi_transform``: rtol
  1e-6, atol 1e-8;
- ``training_rollout_loss`` on 4 windows × 10 frames of the committed GC
  scene (337 agents, 4,094 obstacle points, pretrained ``pinnsf_bm``
  weights, dropout 0): loss to rtol 1e-4, gradients to relative L2 1e-3
  per parameter tensor.  Both packages get the same window arrays, so only
  the rollout and the loss are compared; the feature rebuild inside the
  rollout uses matmul-expansion distances on both sides, whose near-ties
  may order neighbour slots differently (the per-edge forces are summed,
  so only rounding moves).
"""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.serialization import msgpack_restore

import _torch_compare  # noqa: F401  (shares the cores between workers)
from piml_tpu.config import PIMLConfig as JaxConfig
from piml_tpu.data import make_time_indexed as jax_make_time_indexed
from piml_tpu.data.datasets import channel_batches as jax_channel_batches
from piml_tpu.data.views import to_channeled as jax_to_channeled
from piml_tpu.data.views import window_slice as jax_window_slice
from piml_tpu.engine.simulator import training_rollout_loss as jax_loss
from piml_tpu.models import ModelSpec as JaxSpec
from piml_tpu.models import build_finetune_model as jax_build_finetune
from piml_tpu.scene import Scene as JaxScene
from piml_tpu.train import losses as jax_losses
from piml_tpu_torch.config import PIMLConfig
from piml_tpu_torch.data import (ChanneledData, channel_batches,
                                 make_time_indexed, to_channeled,
                                 window_slice)
from piml_tpu_torch.engine import evaluate_rollouts, training_rollout_loss
from piml_tpu_torch.models import (PRETRAINED, ModelSpec, build_finetune_model,
                                   build_model, load_fixture,
                                   params_from_flax, pretrain_model_name)
from piml_tpu_torch.models.blocks import dropout
from piml_tpu_torch.scene import Scene, codec
from piml_tpu_torch.train import losses
from piml_tpu_torch.train.trainer import (MetricLogger, Trainer,
                                          checkpoint_path, load_params,
                                          make_batches, make_optimizer,
                                          merge_pretrained, save_params)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "repro_work", "gc_sf_repro.npy")
PRE_MSGPACK = os.path.join(REPO, "bench_fixtures",
                           "pinnsf_bm_gc_pretrained.msgpack")
FRAMES = 60
WINDOWS = [26, 30, 40, 45]     # windows past skip_frames: predictable rows
# the bench's finetune hyper-parameters (bench.py:352), plus the teacher
# term so that every loss term is live
CFG = dict(model="pinnsf_bm", dataset_name="gc2344", dropout=0.0,
           skip_frames=25, time_unit=0.08, valid_steps=10, ft_batch_size=4,
           learning_rate=2e-4, weight_decay=1e-6, finetune_lr_decay=0.02,
           collision_pred_weight=5e-2, collision_loss_weight=200.0,
           hard_collision_penalty=2.0, time_decay=0.9, reg_weight=1e-2,
           collision_loss_version="v2", teacher_weight=0.5)
T_KEYED = ("position", "velocity", "acceleration", "destination", "dest_idx",
           "mask_p", "mask_v", "mask_a")


def _arrays(start, stop):
    arrays = codec.decode(SCENE)
    for key in T_KEYED:
        arrays[key] = arrays[key][start:stop]
    return arrays


def _to_port(jb) -> ChanneledData:
    """A JAX ChanneledData as the port's, array for array."""
    return ChanneledData(
        **{f.name: torch.from_numpy(np.array(getattr(jb, f.name)))
           for f in dataclasses.fields(ChanneledData)
           if f.name != "meta_data"},
        meta_data=dict(jb.meta_data))


def _to_time_indexed_port(jdata):
    from piml_tpu_torch.data import TimeIndexedData

    return TimeIndexedData(
        **{f.name: torch.from_numpy(np.array(getattr(jdata, f.name)))
           for f in dataclasses.fields(TimeIndexedData)
           if f.name != "meta_data"},
        meta_data=dict(jdata.meta_data))


@pytest.fixture(scope="module")
def gc_windows():
    arrays = _arrays(0, FRAMES)
    jcfg = JaxConfig(**CFG)
    jdata = jax_make_time_indexed(jcfg, JaxScene.from_arrays(arrays))
    tdata = make_time_indexed(PIMLConfig(**CFG),
                              Scene.from_arrays(arrays, device="cpu"))
    with open(PRE_MSGPACK, "rb") as f:
        params = msgpack_restore(f.read())
    return dict(jcfg=jcfg, jdata=jdata, tdata=tdata, params=params)


def _rel_l2(got, ref):
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


# ---------------------------------------------------------------------------
# views and batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["slice", "split"])
def test_window_slice_matches_jax(rng, mode):
    x = rng.randn(23, 5, 2).astype(np.float32)
    ref = np.asarray(jax_window_slice(jnp.asarray(x), 4, mode))
    got = window_slice(torch.from_numpy(x), 4, mode).numpy()
    np.testing.assert_array_equal(got, ref)


def test_to_channeled_matches_jax(gc_windows):
    ref = jax_to_channeled(gc_windows["jdata"], 10, "slice")
    got = to_channeled(_to_time_indexed_port(gc_windows["jdata"]), 10,
                       "slice")
    assert got.num_channels == ref.num_channels == FRAMES - 10
    assert got.num_frames == ref.num_frames == 10
    assert got.time_unit == ref.time_unit
    for f in dataclasses.fields(ChanneledData):
        if f.name != "meta_data":
            np.testing.assert_array_equal(
                getattr(got, f.name).numpy(), np.asarray(getattr(ref, f.name)),
                err_msg=f.name)


@pytest.mark.parametrize("shuffle", [False, True])
def test_channel_batches_match_jax(gc_windows, shuffle):
    jch = jax_to_channeled(gc_windows["jdata"], 10, "slice")
    tch = _to_port(jch)
    ref = jax_channel_batches([jch, jch], 8, np.random.RandomState(3),
                              shuffle=shuffle)
    got = channel_batches([tch, tch], 8, np.random.RandomState(3),
                          shuffle=shuffle)
    assert len(got) == len(ref) == 2 * ((FRAMES - 10) // 8)
    for g, r in zip(got, ref):
        for name in ("position", "mask_p_pred", "ped_features", "dest_idx"):
            np.testing.assert_array_equal(getattr(g, name).numpy(),
                                          np.asarray(getattr(r, name)))


def test_make_batches_drop_last_and_shuffle():
    got = make_batches(10, 4, np.random.RandomState(0))
    assert [len(b) for b in got] == [4, 4]
    assert len(set(np.concatenate(got))) == 8
    tail = make_batches(10, 4, np.random.RandomState(0), shuffle=False,
                        drop_last=False)
    np.testing.assert_array_equal(tail[-1], [8, 9])


# ---------------------------------------------------------------------------
# losses and the optimizer
# ---------------------------------------------------------------------------

def _loss_inputs(rng):
    c, t, n = 3, 6, 9
    pred = rng.randn(c, t, n, 2).astype(np.float32)
    lab = rng.randn(c, t, n, 2).astype(np.float32)
    coll = (rng.rand(c, t, n) < 0.2).astype(np.float32)
    abnormal = (rng.rand(n) < 0.7).astype(np.float32)
    prob = rng.rand(c, t, n, 4).astype(np.float32)
    target = (rng.rand(c, t, n, 4) < 0.3).astype(np.float32)
    return pred, lab, coll, abnormal, prob, target


LOSS_CASES = {
    "mse": lambda L, a: L.mse_loss(a[0], a[1], "sum"),
    "l1_reg": lambda L, a: L.l1_reg_loss(a[0], 1e-2, "mean"),
    "decayed_mse": lambda L, a: L.multiple_rollout_mse_loss(
        a[0], a[1], 0.9, "sum"),
    "decayed_mse_reverse": lambda L, a: L.multiple_rollout_mse_loss(
        a[0], a[1], 0.9, "sum", reverse=True),
    "avoidance": lambda L, a: L.multiple_rollout_collision_avoidance_loss(
        a[0], a[1], 0.9, "sum"),
    "collision_v0": lambda L, a: L.multiple_rollout_collision_loss(
        a[0], a[1], 0.9, a[2], "sum"),
    "collision_v2": lambda L, a: L.multiple_rollout_collision_loss(
        a[0], a[1], 0.9, a[2], "sum", a[3]),
    "bce": lambda L, a: L.binary_cross_entropy(a[4], a[5], "sum"),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_matches_jax(rng, case):
    args = _loss_inputs(rng)
    ref = LOSS_CASES[case](jax_losses, [jnp.asarray(a) for a in args])
    got = LOSS_CASES[case](losses, [torch.from_numpy(a) for a in args])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def test_adam_steps_match_optax(rng):
    """Adam with coupled L2 decay (the finetune's lr and wd scales) against
    optax's add_decayed_weights → scale_by_adam → scale(-lr), two steps
    from identical gradients."""
    cfg = PIMLConfig(**CFG)
    lr = cfg.learning_rate * cfg.finetune_lr_decay
    wd = cfg.weight_decay * cfg.finetune_wd_aug
    params = {"w": rng.randn(7, 5).astype(np.float32),
              "b": rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(2)]
    tx = optax.chain(optax.add_decayed_weights(wd), optax.scale_by_adam(),
                     optax.scale(-lr))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = make_optimizer(cfg, list(tp.values()), finetune=True)
    assert opt.param_groups[0]["lr"] == pytest.approx(lr)
    assert opt.param_groups[0]["weight_decay"] == pytest.approx(wd)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_optimizer_for_unported_finetunes_raises():
    """The per-group finetune optimizer splits parameters by name: given
    plain parameters it refuses, given the model it builds its groups."""
    cfg = PIMLConfig(**{**CFG, "model": "pinnsf_res"})
    with pytest.raises(ValueError):
        make_optimizer(cfg, [torch.nn.Parameter(torch.zeros(2))],
                       finetune=True)
    model = build_finetune_model(ModelSpec.from_config(cfg))
    opt = make_optimizer(cfg, model, finetune=True)
    assert len(opt.param_groups) == 2


TINY_W = dict(encoder_hidden_size=32, processor_hidden_size=32,
              decoder_hidden_size=16, processor_hidden_layers=2,
              res_hidden_layers=2)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("name", ["base", "pinnsf_res"])
def test_grouped_adam_matches_optax_multi_transform(rng, name):
    """The ``base`` and ``pinnsf_res`` finetunes: the corrector group at
    ``lr·ft_lr_decay2``, the pretrained one at ``lr·finetune_lr_decay``,
    both with decay ``wd``; three steps from identical gradients against
    the JAX package's ``optax.multi_transform``, to rtol 1e-6 and atol
    1e-8 (about one float32 step of the initial weights, ~0.1: a weight
    that the updates carry near zero keeps its old value's rounding)."""
    from piml_tpu.train.trainer import make_optimizer as jax_make_optimizer

    kw = dict(CFG, model=name, ft_lr_decay2=0.5, finetune_wd_aug=3.0,
              weight_decay=1e-3, **TINY_W)
    jcfg, cfg = JaxConfig(**kw), PIMLConfig(**kw)
    jmodel = jax_build_finetune(JaxSpec.from_config(jcfg))
    pf = rng.randn(3, 6, 6).astype(np.float32)
    of = rng.randn(3, 10, 6).astype(np.float32)
    sf = rng.randn(3, 7).astype(np.float32)
    jp = jmodel.init(jax.random.PRNGKey(0), pf, of, sf)
    model = build_finetune_model(ModelSpec.from_config(cfg))
    model.load_state_dict(params_from_flax(_np_tree(jp)), strict=True)
    opt = make_optimizer(cfg, model, finetune=True)
    lr = cfg.learning_rate
    assert [g["lr"] for g in opt.param_groups] == pytest.approx(
        [lr * cfg.ft_lr_decay2, lr * cfg.finetune_lr_decay])
    assert [g["weight_decay"] for g in opt.param_groups] == [1e-3, 1e-3]
    corrector = {n for n, _ in model.named_parameters() if "corrector" in n}
    assert corrector and len(corrector) < len(list(model.parameters()))
    tx = jax_make_optimizer(jcfg, finetune=True)
    state = tx.init(jp)

    @jax.jit
    def step(grads, state, params):
        upd, state = tx.update(grads, state, params)
        return optax.apply_updates(params, upd), state

    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: rng.randn(*x.shape).astype(np.float32), jp)
        jp, state = step(grads, state, jp)
        tgrads = params_from_flax(_np_tree(grads))
        for n, p in model.named_parameters():
            p.grad = tgrads[n].clone()
        opt.step()
    ref = params_from_flax(_np_tree(jp))
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[n].numpy(),
                                   rtol=1e-6, atol=1e-8, err_msg=n)


@pytest.mark.parametrize("name", ["pinnsf2", "pinnsf_res"])
def test_pointwise_loss_gradients_match_jax(rng, name):
    """The pointwise loss and its gradients through ``pinnsf2``'s
    learnable τ (``tau_delta``, with its weight decay left to the
    optimizer) and through the ``pinnsf_res`` corrector, against
    ``jax.value_and_grad``."""
    from piml_tpu.train import Trainer as JaxTrainer
    from piml_tpu.utils import MetricLogger as JaxLogger

    kw = dict(CFG, model=name, reg_weight=1e-2, **TINY_W)
    jtrainer = JaxTrainer(JaxConfig(**kw), JaxLogger(stream=open(os.devnull,
                                                                 "w")))
    trainer = Trainer(PIMLConfig(**kw), MetricLogger(
        stream=open(os.devnull, "w")))
    spec = ModelSpec.from_config(trainer.cfg)
    if name == "pinnsf_res":      # the corrector is the finetune model's
        jtrainer.model = jax_build_finetune(JaxSpec.from_config(jtrainer.cfg))
        trainer.model = build_finetune_model(spec)
    else:
        trainer.model = build_model(spec)
    batch = [rng.randn(48, 6, 6), rng.randn(48, 10, 6), rng.randn(48, 7),
             rng.randn(48, 7)]
    batch = [b.astype(np.float32) for b in batch]
    jparams = _np_tree(jtrainer.model.init(jax.random.PRNGKey(1), *batch[:3]))
    if name == "pinnsf2":
        jparams["params"]["tau_delta"] = np.float32(0.3)

    def loss_fn(p):
        return jtrainer._pointwise_loss_terms(
            p, *(jnp.asarray(b) for b in batch), jax.random.PRNGKey(0))

    (ref, _), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(jparams)
    trainer.model.load_state_dict(params_from_flax(jparams), strict=True)
    loss, _ = trainer._pointwise_loss_terms(*(torch.from_numpy(b)
                                              for b in batch))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(ref), rel=1e-5)
    gref = params_from_flax(_np_tree(jgrads))
    for n, p in trainer.model.named_parameters():
        err = _rel_l2(p.grad.numpy(), gref[n].numpy())
        assert err <= 1e-4, (n, err)
    if name == "pinnsf2":
        assert float(trainer.model.tau_delta.grad) != 0.0
        assert float(trainer.model.tau_delta.grad) == pytest.approx(
            float(gref["tau_delta"]), rel=1e-5)


# ---------------------------------------------------------------------------
# models: dropout, registry, warm start, checkpoints
# ---------------------------------------------------------------------------

def _gens(*seeds):
    return [torch.Generator().manual_seed(s) for s in seeds]


def test_dropout_masks_follow_the_generator():
    x = torch.ones(1, 100_000)
    a = dropout(x, 0.5, _gens(7))
    b = dropout(x, 0.5, _gens(7))
    c = dropout(x, 0.5, _gens(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    keep = (a > 0).double().mean().item()
    assert abs(keep - 0.5) <= 0.01 * 0.5
    assert torch.all((a == 0) | (a == 2.0))          # inverted scaling
    assert torch.equal(dropout(x, 0.5, None), x)     # no generator: identity
    # one generator per channel: each channel's mask is its own stream
    per = dropout(torch.ones(2, 1000), 0.3, _gens(7, 9))
    assert torch.equal(per[0], dropout(torch.ones(1, 1000), 0.3,
                                       _gens(7))[0])
    assert abs((per > 0).double().mean().item() - 0.7) < 0.05
    with pytest.raises(ValueError):
        dropout(torch.ones(3, 10), 0.3, _gens(7, 9))


def test_finetune_registry():
    spec = ModelSpec.from_config(PIMLConfig(**CFG))
    assert type(build_finetune_model(spec)) is type(build_model(spec))
    res = build_finetune_model(dataclasses.replace(spec, name="pinnsf_res"))
    assert res.corrector and not build_model(
        dataclasses.replace(spec, name="pinnsf")).corrector
    base = build_finetune_model(dataclasses.replace(spec, name="base"))
    assert base.corrector_on and not build_model(
        dataclasses.replace(spec, name="base")).corrector_on
    assert pretrain_model_name("pinnsf_res") == "pinnsf"
    assert pretrain_model_name("pinnsf_bm") == "pinnsf_bm"


def test_merge_pretrained_by_name_and_shape():
    fresh = {"a": torch.zeros(2, 3), "b": torch.zeros(4), "c": torch.zeros(1)}
    pre = {"a": torch.ones(2, 3), "b": torch.ones(5), "d": torch.ones(1)}
    got = merge_pretrained(fresh, pre)
    assert torch.equal(got["a"], pre["a"])           # name and shape match
    assert torch.equal(got["b"], fresh["b"])         # shape differs
    assert torch.equal(got["c"], fresh["c"])         # absent
    assert set(got) == set(fresh)


def test_checkpoint_round_trip(tmp_path):
    cfg = PIMLConfig(**{**CFG, "save_dir": str(tmp_path), "exp_name": "x",
                        "model_name_suffix": "abc"})
    assert checkpoint_path(cfg, False) == str(tmp_path / "x_abc")
    assert checkpoint_path(cfg, True) == str(tmp_path / "x_abc_finetuned")
    model = build_model(ModelSpec.from_config(cfg))
    save_params(checkpoint_path(cfg, True), model.state_dict())
    back = load_params(checkpoint_path(cfg, True))
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k


# ---------------------------------------------------------------------------
# the training loss
# ---------------------------------------------------------------------------

def _finetune_model(cfg, params):
    model = build_finetune_model(ModelSpec.from_config(cfg))
    model.load_state_dict(params_from_flax(params))
    return model


def test_training_rollout_loss_matches_jax(gc_windows):
    """Loss terms and gradients of the BPTT loss against
    ``jax.value_and_grad`` of the JAX package's, on the same windows."""
    g = gc_windows
    jcfg = g["jcfg"]
    jb = jax_to_channeled(g["jdata"], 10, "slice").slice_channels(
        np.array(WINDOWS))
    jmodel = jax_build_finetune(JaxSpec.from_config(jcfg))

    def apply_fn(p, pf, of, sf):
        return jmodel.apply(p, pf, of, sf)

    def loss_fn(p):
        out = jax_loss(p, apply_fn, jcfg, jb)
        return out.loss, out

    (_, ref), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(g["params"])

    cfg = PIMLConfig(**CFG)
    model = _finetune_model(cfg, g["params"])
    out = training_rollout_loss(model, cfg, _to_port(jb))
    out.loss.backward()
    for key in ref._fields:
        assert float(getattr(out, key).detach()) == pytest.approx(
            float(getattr(ref, key)), rel=1e-4, abs=1e-6), key
    assert float(ref.collision_count) > 0 and float(ref.mse_loss) > 0
    gref = params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        err = _rel_l2(p.grad.numpy(), gref[name].numpy())
        assert err <= 1e-3, (name, err)


def test_training_rollout_loss_live_dropout_is_seeded_and_rematerializable(
        gc_windows):
    """Live dropout draws from the generator's per-frame, per-channel
    seeds: the same seed gives the same loss, another seed another; and a
    checkpointed frame recomputed in the backward draws the same masks, so
    gradients with and without activation checkpointing agree."""
    cfg = PIMLConfig(**{**CFG, "dropout": 0.5})
    batch = to_channeled(gc_windows["tdata"], 10, "slice").slice_channels(
        WINDOWS[:2])
    results = {}
    for label, remat, seed in (("remat", True, 0), ("plain", False, 0),
                               ("other", False, 1)):
        model = _finetune_model(cfg, gc_windows["params"])
        out = training_rollout_loss(
            model, cfg.replace(remat_features=remat), batch,
            generator=torch.Generator().manual_seed(seed))
        out.loss.backward()
        results[label] = (out.loss.item(),
                          {n: p.grad.clone()
                           for n, p in model.named_parameters()})
    assert results["remat"][0] == results["plain"][0]
    for name, grad in results["plain"][1].items():
        torch.testing.assert_close(results["remat"][1][name], grad,
                                   rtol=1e-5, atol=1e-6)
    assert results["other"][0] != results["plain"][0]


def test_pretrained_warm_start_loads(gc_windows):
    """The committed pretrained npz is the warm start the trainer merges."""
    cfg = PIMLConfig(**CFG)
    model = build_finetune_model(ModelSpec.from_config(cfg))
    merged = merge_pretrained(model.state_dict(), load_fixture(PRETRAINED))
    ref = params_from_flax(gc_windows["params"])
    for k in ref:
        assert torch.equal(merged[k], ref[k]), k


def test_trainer_finetune_two_epochs_on_cpu(gc_windows, tmp_path):
    """Two epochs from the pretrained weights, validated on a held-out
    frame range; the best parameters come back, and reloaded from their
    checkpoint they give the best validation loss again."""
    cfg = PIMLConfig(**{**CFG, "epochs": 2, "save_dir": str(tmp_path),
                        "exp_name": "ft", "model_name_suffix": "cpu",
                        "patience": 5})
    ch = to_channeled(gc_windows["tdata"], 10, "slice").slice_channels(
        list(range(26, 34)))
    batches = channel_batches([ch], 4, np.random.RandomState(cfg.seed),
                              shuffle=True)
    valid = make_time_indexed(
        cfg, Scene.from_arrays(_arrays(60, 100), device="cpu"))
    logger = MetricLogger(stream=open(os.devnull, "w"))
    trainer = Trainer(cfg, logger)
    state = trainer.finetune(batches, [valid],
                             pretrained=load_fixture(PRETRAINED))
    train_logs = [r for r in logger.records if "train_loss" in r]
    val_logs = [r["val_loss"] for r in logger.records if "val_loss" in r]
    assert [r["epoch"] for r in train_logs] == [0, 1]
    assert len(val_logs) == 3                       # baseline + 2 epochs
    assert all(math.isfinite(r["train_loss"]) for r in train_logs)
    assert all(math.isfinite(v) for v in val_logs)
    assert state.best_val == min(val_logs)
    fresh = build_finetune_model(ModelSpec.from_config(cfg))
    fresh.load_state_dict(load_params(checkpoint_path(cfg, True)))
    again = evaluate_rollouts(fresh, cfg, [valid], test_flag=False)
    assert again.loss == pytest.approx(state.best_val, rel=1e-6)


def test_finetune_refuses_several_devices():
    """``n_devices > 1`` shards the finetune's channels over a process
    group of that many ranks (``tests/test_torch_parallel.py`` runs it);
    without one it raises and names the launcher, before it reads any
    batch, rather than run on one device."""
    trainer = Trainer(PIMLConfig(**CFG, n_devices=2),
                      MetricLogger(stream=open(os.devnull, "w")))
    with pytest.raises(RuntimeError,
                       match=r"n_devices=2 .* torchrun --nproc_per_node=2"):
        trainer.finetune(train_batches=[])


def test_model_spec_carries_compute_dtype():
    """``--compute_dtype bfloat16`` reaches the model: its interaction
    stacks compute in bfloat16 on float32 parameters."""
    spec = ModelSpec.from_config(PIMLConfig(**{**CFG,
                                               "compute_dtype": "bfloat16"}))
    assert spec.compute_dtype == "bfloat16"
    assert spec.nn_dtype is torch.bfloat16
    model = build_model(spec)
    assert model.ped_encoder.dtype is torch.bfloat16
    assert model.collision_head.dtype is None      # JAX gives it none
    assert all(p.dtype == torch.float32 for p in model.parameters())
    plain = ModelSpec.from_config(PIMLConfig(**CFG))
    assert plain.compute_dtype is None and plain.nn_dtype is None


def _res_finetune(gc_windows, save_dir, epochs, resume):
    cfg = PIMLConfig(**{**CFG, **TINY_W, "model": "pinnsf_res",
                        "ft_lr_decay2": 0.5, "dropout": 0.5,
                        "epochs": epochs, "resume": resume,
                        "save_dir": str(save_dir), "exp_name": "res",
                        "model_name_suffix": "r", "patience": 5,
                        "ft_patience": 5})
    ch = to_channeled(gc_windows["tdata"], 10, "slice").slice_channels(
        [26, 38])
    batches = channel_batches([ch], 2, np.random.RandomState(cfg.seed),
                              shuffle=True)
    valid = make_time_indexed(
        cfg, Scene.from_arrays(_arrays(30, 60), device="cpu"))
    logger = MetricLogger(stream=open(os.devnull, "w"))
    state = Trainer(cfg, logger).finetune(batches, [valid])
    return state, [r for r in logger.records if "epoch" in r]


def test_resumed_pinnsf_res_finetune_is_bit_identical(gc_windows, tmp_path):
    """The corrector finetune with its two Adam groups and live dropout:
    one epoch, then a new trainer resuming to two, equals two epochs in
    one go, bit for bit."""
    whole, whole_logs = _res_finetune(gc_windows, tmp_path / "a", 2, False)
    _res_finetune(gc_windows, tmp_path / "b", 1, True)
    resumed, logs = _res_finetune(gc_windows, tmp_path / "b", 2, True)
    assert [r["epoch"] for r in logs] == [1]

    def strip(r):
        return {k: v for k, v in r.items() if k != "time"}

    assert strip(logs[0]) == strip([r for r in whole_logs
                                    if r["epoch"] == 1][0])
    assert math.isfinite(logs[0]["train_loss"])
    assert resumed.best_val == whole.best_val
    for name, p in whole.params.items():
        assert torch.equal(resumed.params[name], p), name
    groups = resumed.opt_state["param_groups"]
    assert [g["lr"] for g in groups] == pytest.approx([2e-4 * 0.5,
                                                       2e-4 * 0.02])


def test_run_pinnsf_m_pretrain_matches_jax(tmp_path, monkeypatch):
    """``exp.main.run`` on the default model, ``pinnsf_m`` (small widths),
    against the JAX package's ``run`` on the same scene files from the
    same initial weights, dropout 0: the two pretrain epochs' records to
    rtol 1e-4, as ``test_train_pointwise_two_epochs_match_jax``.  The
    port's pretrain and validation rows are the JAX package's: each
    package's dataset orders the near-tied obstacle points of the scene's
    walls in its own way (``tests/test_torch_pretrain.py`` holds the
    datasets to each other with those ties named), which moves the
    validation loss by ~1e-4 over two epochs."""
    from piml_tpu.data import PointwiseDataset as JaxPointwiseDataset
    from piml_tpu.exp import main as jax_main
    from piml_tpu.train import Trainer as JaxTrainer
    from piml_tpu.utils import MetricLogger as JaxLogger
    from piml_tpu_torch.data import PointwiseData, PointwiseDataset
    from piml_tpu_torch.exp import main as exp_main
    from piml_tpu_torch.scene import crop

    src = Scene.load(SCENE, device="cpu")
    lines = []
    for split, (a, b) in dict(train=(0, 80), valid=(80, 120),
                              test=(120, 160)).items():
        path = str(tmp_path / f"{split}.npy")
        crop(src, a, b, list(range(40))).save(path)
        lines.append(f"{split}:\n  - {path}\n")
    (tmp_path / "data.yaml").write_text("".join(lines))
    kw = dict(model="pinnsf_m", dataset_name="gc2344", skip_frames=5,
              valid_steps=5, dropout=0.0, batch_size=64, epochs=2,
              learning_rate=2e-4, weight_decay=1e-6, reg_weight=1e-2,
              collision_pred_weight=5e-2, patience=5, ft_patience=5,
              data_config=str(tmp_path / "data.yaml"), exp_name="m",
              model_name_suffix="m", **TINY_W)

    class Records(JaxLogger):
        def __init__(self):
            super().__init__(stream=open(os.devnull, "w"))
            self.records = []

        def log(self, **metrics):
            self.records.append(metrics)

    # the port starts from the weights the JAX run initialised
    init = {}
    jax_init = JaxTrainer.init_params

    def keep(self, sample):
        init["params"] = jax_init(self, sample)
        return init["params"]

    monkeypatch.setattr(JaxTrainer, "init_params", keep)
    jax_build_dataset = JaxPointwiseDataset.build_dataset

    def keep_rows(self, cfg):
        init["rows"] = self
        return jax_build_dataset(self, cfg)

    monkeypatch.setattr(JaxPointwiseDataset, "build_dataset", keep_rows)
    jlog = Records()
    ref = jax_main.run(JaxConfig(**kw, save_dir=str(tmp_path / "jax")),
                       jlog)
    port_init = Trainer.init_params

    def load(self, sample):
        port_init(self, sample)
        self.model.load_state_dict(
            params_from_flax(_np_tree(init["params"])), strict=True)
        return self.model.state_dict()

    monkeypatch.setattr(Trainer, "init_params", load)
    build_dataset = PointwiseDataset.build_dataset

    def same_rows(self, cfg):
        cfg = build_dataset(self, cfg)
        for split in ("train_data", "valid_data"):
            ref = getattr(init["rows"], split)
            setattr(self, split, PointwiseData(
                **{k: torch.from_numpy(np.array(getattr(ref, k)))
                   for k in ("ped_features", "obs_features",
                             "self_features", "labels")},
                meta_data=dict(ref.meta_data)))
        return cfg

    monkeypatch.setattr(PointwiseDataset, "build_dataset", same_rows)
    log = MetricLogger(stream=open(os.devnull, "w"))
    got = exp_main.run(PIMLConfig(**kw, save_dir=str(tmp_path / "t")), log,
                       device="cpu")

    def epochs(records, key):
        return [r[key] for r in records if key in r and "epoch" in r]

    for key in ("train_loss", "train_mse", "val_loss"):
        assert len(epochs(log.records, key)) == 2, key
        np.testing.assert_allclose(epochs(log.records, key),
                                   epochs(jlog.records, key), rtol=1e-4,
                                   err_msg=key)
    assert got["pretrain_val"] == pytest.approx(ref["pretrain_val"],
                                                rel=1e-4)
    assert math.isfinite(got["pretrain_test_mae"])

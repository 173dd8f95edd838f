"""The port's parallel layer (``piml_tpu_torch/parallel``) against the JAX
package's (CPU).

The JAX side runs on a 4-device sub-mesh of conftest's virtual CPU mesh
(Pallas in interpret mode, as ``tests/test_sharded_banded.py`` runs it);
the port's side on 4 gloo ranks on the CPU, started once for the whole
module by ``parallel.spawn_local``.  The ranks run
``tests/_torch_parallel_ranks.py::run_all`` (which imports no JAX) on the
same numpy inputs, made here from seeds; every rank's results must equal
rank 0's, which are held to the JAX package's.

Tolerances, each beside its assert:
- K2 with ``self_ids``: distances to rtol 1e-6 (the FMA standing
  difference, 1 ulp), ids equal on finite slots, the exactness flags equal;
- padding: bitwise;
- ring pass on a lattice (exact small-integer distances): the selected
  rows bitwise, so the tie order is JAX's; elsewhere the features within
  1e-5 (ring: matmul-expansion rounding) or 1e-6 (K2), rows beyond that
  only at near-ties, named by ``_torch_compare.assert_features_match``;
- DP steps against JAX's ``make_dp_*_step`` after one Adam step: loss to
  rtol 1e-4, parameters to rtol 1e-4 / atol 1e-5
  (tests/test_sharding.py:71-75); the pointwise step with live dropout
  against the port's single-device step from the same seed: loss to
  rtol 1e-5, parameters to rtol 1e-4 / atol 1e-5;
- ``Trainer.finetune(n_devices=4)`` against the port's single-device run,
  2 epochs: best validation loss to rtol 1e-3, parameters to rtol 5e-4 /
  atol 5e-5 (tests/test_sharding.py's DP soak);
- sharded eval rollout against the single-device one: positions to
  atol 1e-4 m, masks equal; metrics to rtol 1e-4;
- sharded Sinkhorn / MMD against JAX's sharded and single-device values:
  rtol 1e-4 (MMD plus atol 1e-6), as tests/test_parallel_metrics.py;
- TP: the forward to rtol 1e-5 / atol 1e-6, three dp×tp steps' losses to
  rtol 2e-4 and parameters to rtol 5e-4 / atol 5e-5
  (tests/test_tensor_parallel.py).
"""

import concurrent.futures
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import _torch_compare  # noqa: F401  (shares the cores between workers)
from _torch_compare import assert_features_match
from piml_tpu.config import PIMLConfig as JaxConfig
from piml_tpu.data.views import ChanneledData as JaxChanneled
from piml_tpu.metrics.metrics import mmd_masked, sinkhorn_masked
from piml_tpu.models import ModelSpec as JaxSpec
from piml_tpu.models import build_finetune_model as jax_build_finetune
from piml_tpu.models import build_model as jax_build
from piml_tpu.ops.banded import banded_params as jax_banded_params
from piml_tpu.ops.banded import topk_neighbors_banded as jax_banded
from piml_tpu.parallel import agent_shard as jax_agent_shard
from piml_tpu.parallel import metrics_shard as jax_metrics_shard
from piml_tpu.parallel import sharding as jax_sharding
from piml_tpu.parallel import tensor_parallel as jax_tp
from piml_tpu.physics.features import NeighborConfig as JaxNeighborConfig
from piml_tpu.physics.features import heading_direction as jax_heading
from piml_tpu.train.trainer import make_optimizer as jax_optimizer
from piml_tpu_torch import parallel
from piml_tpu_torch.config import PIMLConfig
from piml_tpu_torch.data import (ChanneledData, channel_batches,
                                 make_time_indexed, to_channeled)
from piml_tpu_torch.engine import engine_config, eval_rollout, evaluate_rollouts
from piml_tpu_torch.models import (PRETRAINED, ModelSpec, build_model,
                                   load_fixture, params_from_flax)
from piml_tpu_torch.ops import banded
from piml_tpu_torch.parallel import tensor_parallel
from piml_tpu_torch.scene import Scene, codec
from piml_tpu_torch.train.trainer import (MetricLogger, Trainer,
                                          make_optimizer)

import _torch_parallel_ranks as ranks_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "repro_work", "gc_sf_repro.npy")
T_KEYED = ("position", "velocity", "acceleration", "destination", "dest_idx",
           "mask_p", "mask_v", "mask_a")
RANKS = 4
DENSE = JaxNeighborConfig(use_pallas_topk=False, use_grid_topk=False)
# the tiny finetune configuration of the JAX package's sharding tests
# (__graft_entry__._tiny_cfg), with 6 channels: ragged over 4 ranks
DP_CFG = dict(model="pinnsf_bm", dataset_name="gc2344", skip_frames=4,
              valid_steps=4, encoder_hidden_size=32, encoder_hidden_layers=2,
              processor_hidden_size=32, processor_hidden_layers=2,
              decoder_hidden_size=16, decoder_hidden_layers=2, dropout=0.0,
              batch_size=4, ft_batch_size=6, collision_pred_weight=10.0)
# pinnsf_bm at a tp-divisible width (tests/test_tensor_parallel.py:33-50)
TP_CFG = dict(DP_CFG, encoder_hidden_size=64, processor_hidden_size=64,
              decoder_hidden_size=32)
# the finetune of tests/test_torch_train.py (the bench's hyper-parameters)
TRAINER_CFG = dict(model="pinnsf_bm", dataset_name="gc2344", dropout=0.0,
                   skip_frames=25, time_unit=0.08, valid_steps=10,
                   ft_batch_size=4, learning_rate=2e-4, weight_decay=1e-6,
                   finetune_lr_decay=0.02, collision_pred_weight=5e-2,
                   collision_loss_weight=200.0, hard_collision_penalty=2.0,
                   time_decay=0.9, reg_weight=1e-2,
                   collision_loss_version="v2", teacher_weight=0.5,
                   epochs=2, exp_name="ft", model_name_suffix="dp",
                   patience=5)
ROLL_CFG = dict(model="pinnsf_bm", dataset_name="gc2344", dropout=0.0,
                skip_frames=25, time_unit=0.08)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# inputs, made from seeds
# ---------------------------------------------------------------------------

def _scene(seed, n=160, n_obs=24, absent_frac=0.2, spread=32.0):
    """tests/test_sharded_banded.py's random scene, drawn with numpy."""
    rng = np.random.RandomState(seed)
    p = (rng.rand(n, 2) * spread).astype(np.float32)
    v = rng.randn(n, 2).astype(np.float32)
    a = (0.1 * rng.randn(n, 2)).astype(np.float32)
    dest = (rng.rand(n, 2) * spread).astype(np.float32)
    obs = (rng.rand(n_obs, 2) * spread).astype(np.float32)
    absent = rng.rand(n) < absent_frac
    for x in (p, v, a):
        x[absent] = np.nan
    return dict(p=p, v=v, a=a, dest=dest, obs=obs)


# every scene has 160 agents and 24 obstacle points, so that each JAX
# sharded pass compiles once
def _cluster(n=160, n_obs=24):
    """tests/test_sharded_banded.py:109: a tight cluster at the origin
    whose k-th neighbours lie outside the provable bound; the obstacles
    far away."""
    rng = np.random.RandomState(11)
    far = 1e4 + np.arange(n_obs, dtype=np.float32)
    return dict(p=(0.5 * rng.randn(n, 2)).astype(np.float32),
                v=np.ones((n, 2), np.float32), a=np.zeros((n, 2), np.float32),
                dest=np.full((n, 2), 10.0, np.float32),
                obs=np.stack([far, far], -1))


def _lattice(rows=16, cols=10):
    """Agents on a unit lattice with axis headings: every distance is
    exact, so neighbours tie in groups and only the tie order decides."""
    p = np.stack(np.meshgrid(np.arange(rows, dtype=np.float32),
                             np.arange(cols, dtype=np.float32),
                             indexing="ij"), -1).reshape(-1, 2)
    dirs = np.array([[1, 0], [0, 1], [-1, 0], [0, -1]], np.float32)
    v = dirs[np.arange(p.shape[0]) % 4]
    return dict(p=p, v=v, a=np.zeros_like(p), dest=p + 5.0,
                obs=(p[::7][:24] + 0.5).astype(np.float32))


def _tiny_batch(seed=0, C=6, T=12, N=8, k1=6, k2=4):
    """``__graft_entry__._tiny_batchdata`` drawn with numpy."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    pos = (rng.rand(C, T, N, 2) * 10).astype(f32)
    vel = rng.randn(C, T, N, 2).astype(f32)
    acc = (rng.randn(C, T, N, 2) * 0.2).astype(f32)
    wp = (rng.rand(2, N, 2) * 10).astype(f32)
    dest = np.broadcast_to(wp[0][None, None], (C, T, N, 2)).copy()
    ds = np.full((N,), 1.34, f32)
    self_f = np.concatenate(
        [dest - pos, vel, acc,
         np.broadcast_to(ds[None, None, :, None], (C, T, N, 1))], -1)
    labels = np.concatenate([pos, vel, acc, np.zeros((C, T, N, k1), f32)],
                            -1)
    ones = np.ones((C, T, N), f32)
    return dict(
        ped_features=rng.randn(C, T, N, k1, 6).astype(f32),
        obs_features=rng.randn(C, T, N, k2, 6).astype(f32),
        self_features=self_f.astype(f32), labels=labels, mask_p=ones,
        mask_v=ones, mask_a=ones, mask_p_pred=ones, mask_v_pred=ones,
        mask_a_pred=ones, position=pos, velocity=vel, acceleration=acc,
        destination=dest, dest_idx=np.zeros((C, T, N), np.int32),
        abnormal_mask=np.ones((N,), f32),
        dest_num=np.full((N,), 2, np.int32), waypoints=wp,
        obstacles=np.full((4, 2), 1e4, f32), desired_speed=ds)


def _jax_args(sc):
    return [jnp.asarray(sc[k]) for k in ("p", "v", "a", "dest", "obs")]


def _jax_batch(arrays):
    return JaxChanneled(**{k: jnp.asarray(v) for k, v in arrays.items()},
                        meta_data={"time_unit": 0.08})


def _port_batch(arrays):
    return ChanneledData(**{k: torch.from_numpy(np.array(v))
                            for k, v in arrays.items()},
                         meta_data={"time_unit": 0.08})


def _clouds(seed, n, m, frac_invalid=0.2):
    """tests/test_parallel_metrics.py's clouds, drawn with numpy."""
    rng = np.random.RandomState(seed)
    x = (rng.rand(n, 2) * 20.0).astype(np.float32)
    base = x[:m] if m <= n else np.resize(x, (m, 2))
    y = (base + rng.randn(m, 2) * 0.5).astype(np.float32)
    mx = (rng.rand(n) > frac_invalid).astype(np.float32)
    my = (rng.rand(m) > frac_invalid).astype(np.float32)
    return x, y, mx, my


def _frames(seed=2, T=3, N=64):
    rng = np.random.RandomState(seed)
    p = (rng.rand(T, N, 2) * 20.0).astype(np.float32)
    q = (p + rng.randn(T, N, 2) * 0.3).astype(np.float32)
    mask = (rng.rand(T, N) > 0.2).astype(np.float32)
    mask[1] = 0.0          # a frame with one present agent is skipped
    mask[1, 0] = 1.0
    return dict(p=p, q=q, mask=mask)


def _flax_params(model, seed, *inputs):
    return _np_tree(model.init(jax.random.PRNGKey(seed), *inputs))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    jcfg = JaxConfig(**DP_CFG)
    batch = _tiny_batch()
    jb = _jax_batch(batch)
    ft = jax_build_finetune(JaxSpec.from_config(jcfg))
    dp_params = _flax_params(ft, 0, jb.ped_features[0, 0],
                             jb.obs_features[0, 0], jb.self_features[0, 0])
    rng = np.random.RandomState(5)
    pw = dict(ped=rng.randn(16, 6, 6).astype(np.float32),
              obs=rng.randn(16, 4, 6).astype(np.float32),
              self_f=np.concatenate([rng.randn(16, 6), np.ones((16, 1))],
                                    -1).astype(np.float32),
              labels=rng.randn(16, 12).astype(np.float32))
    pre = jax_build(JaxSpec.from_config(jcfg))
    pw_params = _flax_params(pre, 1, pw["ped"], pw["obs"], pw["self_f"])
    tp = jax_build(JaxSpec.from_config(JaxConfig(**TP_CFG)))
    tp_inputs = dict(ped=rng.randn(16, 6, 6).astype(np.float32),
                     obs=rng.randn(16, 10, 6).astype(np.float32),
                     self_f=pw["self_f"])
    tp_params = _flax_params(tp, 2, tp_inputs["ped"], tp_inputs["obs"],
                             tp_inputs["self_f"])
    arrays = codec.decode(SCENE)
    for key in T_KEYED:          # the frames the cases read
        arrays[key] = arrays[key][:90]
    return dict(
        scenes=dict(spread=_scene(0), spread_full=_scene(1, absent_frac=0.0),
                    cluster=_cluster(), lattice=_lattice()),
        clouds=dict(ragged=_clouds(3, 91, 85)),
        frames=_frames(),
        dp_cfg=DP_CFG, dp_batch=batch, dp_params=dp_params,
        pw=pw, pw_params=pw_params, pw_dropout=0.25, pw_seed=7,
        tp_cfg=TP_CFG, tp_inputs=tp_inputs, tp_params=tp_params,
        gc_arrays=arrays,
        gc_t_keyed=T_KEYED,
        trainer_cfg=TRAINER_CFG, trainer_frames=(0, 45),
        trainer_windows=list(range(26, 30)), trainer_valid_frames=(60, 90),
        trainer_dir=str(tmp_path_factory.mktemp("dp_trainer")),
        roll_cfg=ROLL_CFG, roll_frames=40)


def _run_ranks(inputs):
    results = parallel.spawn_local(ranks_mod.run_all, RANKS, "gloo", "cpu",
                                   args=(inputs,), timeout=600)
    for r in range(1, RANKS):
        _assert_same(results[r], results[0], f"rank {r}")
    return results[0]


@pytest.fixture(scope="module")
def port(inputs):
    """Every case on 4 gloo ranks, started in the background so that the
    JAX side runs meanwhile: a future of rank 0's results, after checking
    that every rank returned the same.  A test computes its JAX reference,
    then reads ``port.result()``."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = pool.submit(_run_ranks, inputs)
        yield future
        future.result()


def _assert_same(a, b, where):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}/{i}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b or (a != a and b != b), where


@pytest.fixture(scope="module")
def mesh4():
    if len(jax.devices()) < RANKS:
        pytest.skip("needs 4 virtual devices")
    return Mesh(np.array(jax.devices()[:RANKS]), ("ap",))


@pytest.fixture(scope="module")
def refs(port, inputs, mesh4):
    """The JAX package's results for every case, computed while the ranks
    run (``port`` starts them first)."""
    scenes = inputs["scenes"]
    ring = jax.jit(lambda *a: jax_agent_shard.sharded_relative_features(
        *a, DENSE, mesh4))
    banded_fn = jax.jit(lambda *a: jax_agent_shard.sharded_banded_features(
        *a, DENSE, mesh4))
    lattice = scenes["lattice"]
    v = jnp.asarray(lattice["v"])
    state = jnp.concatenate([jnp.asarray(lattice["p"]), v,
                             jnp.asarray(lattice["a"])], -1)
    return dict(
        ring={k: _np_tree(ring(*_jax_args(scenes[k])))
              for k in ("spread", "spread_full", "lattice")},
        ring_topk=_np_tree(jax_agent_shard.ring_topk_neighbors(
            state, jax_heading(v, time_axis=False), DENSE.topk_ped,
            DENSE.sight_angle_ped, mesh4)),
        banded={k: _np_tree(banded_fn(*_jax_args(scenes[k])))
                for k in ("spread", "spread_full", "cluster")},
        dp_finetune=_ref_dp_finetune(inputs),
        dp_pointwise=_ref_dp_pointwise(inputs),
        clouds={k: _ref_clouds(*c, mesh4)
                for k, c in inputs["clouds"].items()},
        time_masked=_ref_time_masked(inputs["frames"], mesh4),
        tp_dp=_ref_tp_dp(inputs))


# ---------------------------------------------------------------------------
# K2 with self_ids, padding: no process group needed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("angle", [90.0, 180.0])
def test_k2_self_ids_matches_jax(angle):
    """K2 on a shard of the object table's queries with their global ids
    (the sharded caller's launch): JAX's ``topk_neighbors_banded(...,
    self_ids=)`` in interpret mode against the port's plain version."""
    sc = _scene(4, n=512, absent_frac=0.1)
    head = np.array(jax_heading(jnp.nan_to_num(jnp.asarray(sc["v"])),
                                time_axis=False))
    lo, hi = 128, 256
    g, w = jax_banded_params(hi - lo, 512, 6, fine=True)
    ids = np.arange(lo, hi)
    kw = dict(objects=sc["p"], same_objects=False, grid_dim=g, window=w,
              dist_threshold=4.0)
    d_j, i_j, ex_j = jax_banded(
        jnp.asarray(sc["p"][lo:hi]), jnp.asarray(head[lo:hi]), 6, angle,
        interpret=True, self_ids=jnp.asarray(ids),
        **{**kw, "objects": jnp.asarray(sc["p"])})
    d_t, i_t, ex_t = banded.topk_neighbors_banded(
        torch.from_numpy(sc["p"][lo:hi]), torch.from_numpy(head[lo:hi]), 6,
        angle, self_ids=torch.from_numpy(ids),
        **{**kw, "objects": torch.from_numpy(sc["p"])})
    assert bool(ex_t) == bool(ex_j)
    d_j, i_j = np.asarray(d_j), np.asarray(i_j)
    np.testing.assert_array_equal(np.isfinite(d_t.numpy()), np.isfinite(d_j))
    fin = np.isfinite(d_j)
    np.testing.assert_allclose(d_t.numpy()[fin], d_j[fin], rtol=1e-6)
    np.testing.assert_array_equal(i_t.numpy()[fin], i_j[fin])
    if angle == 180.0:
        # the self pair is in view there: each row's nearest slot is itself
        live = np.isfinite(sc["p"][lo:hi]).all(-1)
        np.testing.assert_array_equal(i_t.numpy()[live, 0], ids[live])


@pytest.mark.parametrize("stacked", [False, True])
def test_pad_channels_matches_jax_bitwise(stacked):
    """Inert channels: NaN positions and destinations, zeros elsewhere."""
    arrays = _tiny_batch(seed=1)
    jb, tb = _jax_batch(arrays), _port_batch(arrays)
    if stacked:
        jb = jax.tree_util.tree_map(lambda x: jnp.stack([x, x + 1]), jb)
        tb = dataclasses.replace(tb, **{
            f.name: torch.stack([getattr(tb, f.name), getattr(tb, f.name) + 1])
            for f in dataclasses.fields(tb) if f.name != "meta_data"})
        ref = jax_sharding.pad_channels_stacked(jb, 4)
        got = parallel.pad_channels_stacked(tb, 4)
    else:
        ref = jax_sharding.pad_channels(jb, 4)
        got = parallel.pad_channels(tb, 4)
    assert got.ped_features.shape[int(stacked)] == 8
    for f in dataclasses.fields(ChanneledData):
        if f.name != "meta_data":
            np.testing.assert_array_equal(
                getattr(got, f.name).numpy(), np.asarray(getattr(ref, f.name)),
                err_msg=f.name)


def test_finetune_raises_without_a_group_of_that_size():
    """``n_devices > 1`` needs a process group of exactly that many ranks
    (torchrun or spawn_local); this process has none."""
    trainer = Trainer(PIMLConfig(**DP_CFG, n_devices=4),
                      MetricLogger(stream=open(os.devnull, "w")))
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node=4"):
        trainer.finetune(train_batches=[])


def test_spawn_local_refuses_nccl_on_one_card():
    """NCCL refuses two ranks on one device: the launcher says so before
    it starts a process (gloo shares a card)."""
    with pytest.raises(ValueError, match="NCCL refuses several ranks"):
        parallel.spawn_local(ranks_mod.run_all, 2, "nccl", "cuda:0")


# ---------------------------------------------------------------------------
# the agent-sharded pair pass
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scene", ["spread", "spread_full", "lattice"])
def test_ring_pass_matches_jax(port, refs, scene):
    """``sharded_relative_features`` (ring pass + local obstacle pass)."""
    ref = refs["ring"][scene]
    got = port.result()["features"][scene]["ring"]
    for r, g, name, thr in zip(ref, got, ("ped", "obs", "dest"),
                               (4.0, 4.0, None)):
        if thr is None:
            np.testing.assert_allclose(g, np.asarray(r), atol=1e-6)
        else:
            assert_features_match(np.asarray(r), g, thr, atol=1e-5,
                                  name=f"{scene}/{name}")


def test_ring_topk_keeps_jax_tie_order(port, refs):
    """On the lattice every distance is exact and ties come in groups:
    the selected rows equal JAX's slot for slot."""
    d_j, rows_j = refs["ring_topk"]
    d_t, rows_t = port.result()["features"]["lattice"]["ring_topk"]
    np.testing.assert_array_equal(np.isfinite(d_t), np.isfinite(d_j))
    fin = np.isfinite(np.asarray(d_j))
    np.testing.assert_allclose(d_t[fin], np.asarray(d_j)[fin], rtol=1e-6)
    np.testing.assert_array_equal(rows_t, np.asarray(rows_j))
    fin_t = np.where(np.isfinite(d_t), d_t, -1.0)
    ties = (np.diff(fin_t, axis=1) == 0) & np.isfinite(d_t[:, 1:])
    assert ties.any(axis=1).sum() > 50          # rows whose order is a tie


@pytest.mark.parametrize("scene", ["spread", "spread_full"])
def test_sharded_banded_matches_jax(port, refs, scene):
    """K2's multi-rank caller, exact path: JAX's sharded K2 (interpret
    mode) against the port's (K2's plain version on each rank)."""
    ref = refs["banded"][scene]
    got = port.result()["features"][scene]
    assert got["fallbacks"] == 0
    for r, g, name, thr in zip(ref, got["banded"], ("ped", "obs", "dest"),
                               (4.0, 4.0, None)):
        if thr is None:
            np.testing.assert_allclose(g, np.asarray(r), atol=1e-6)
        else:
            assert_features_match(np.asarray(r), g, thr, atol=1e-6,
                                  name=f"{scene}/{name}")


def test_sharded_banded_falls_back_like_jax(port, refs):
    """The clustered scene fails the proof on some rank: every rank takes
    the ring pass (one fallback counted on each), as JAX's ``lax.cond``."""
    ref = refs["banded"]["cluster"]
    got = port.result()["features"]["cluster"]
    assert got["fallbacks"] == 1
    for r, g, name in zip(ref[:2], got["banded"][:2], ("ped", "obs")):
        assert_features_match(np.asarray(r), g, 4.0, atol=1e-5,
                              name=f"cluster/{name}")
    np.testing.assert_allclose(got["banded"][2], np.asarray(ref[2]),
                               atol=1e-6)
    for a, b in zip(got["banded"], got["ring"]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# data parallelism
# ---------------------------------------------------------------------------

def _ref_dp_finetune(inputs):
    jcfg = JaxConfig(**DP_CFG)
    model = jax_build_finetune(JaxSpec.from_config(jcfg))
    tx = jax_optimizer(jcfg, finetune=True)
    mesh = Mesh(np.array(jax.devices()[:RANKS]), ("dp",))
    step = jax_sharding.make_dp_finetune_step(
        jcfg, lambda p, pf, of, sf: model.apply(p, pf, of, sf), tx, mesh)
    params = inputs["dp_params"]
    p2, _, out = step(jax_sharding.replicate(params, mesh),
                      jax_sharding.replicate(tx.init(params), mesh),
                      jax_sharding.shard_channeled_batch(
                          _jax_batch(inputs["dp_batch"]), mesh))
    return p2, out


def test_dp_finetune_step_matches_jax(port, refs):
    """One channel-DP step, 6 ragged channels over 4 ranks, against JAX's
    ``make_dp_finetune_step`` on the 4-device mesh."""
    p2, out = refs["dp_finetune"]
    got = port.result()["dp"]["finetune"]
    assert got["local_channels"] == 2          # 6 → 8 channels, 2 a rank
    assert got["loss"] == pytest.approx(float(out.loss), rel=1e-4)
    for t, key in zip(got["terms"], out._fields):
        assert t == pytest.approx(float(getattr(out, key)), rel=1e-4,
                                  abs=1e-6), key
    ref = params_from_flax(_np_tree(p2))
    for name, v in got["params"].items():
        np.testing.assert_allclose(v, ref[name].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def _ref_dp_pointwise(inputs):
    jcfg = JaxConfig(**DP_CFG)
    model = jax_build(JaxSpec.from_config(jcfg))
    tx = jax_optimizer(jcfg)
    mesh = Mesh(np.array(jax.devices()[:RANKS]), ("dp",))
    step = jax_sharding.make_dp_pointwise_step(jcfg, model, tx, mesh)
    params = inputs["pw_params"]
    rows = jax_sharding.shard_leading(
        tuple(jnp.asarray(inputs["pw"][k])
              for k in ("ped", "obs", "self_f", "labels")), mesh)
    p2, _, loss = step(jax_sharding.replicate(params, mesh),
                       jax_sharding.replicate(tx.init(params), mesh),
                       *rows, jax.random.PRNGKey(0))
    return p2, loss


def test_dp_pointwise_step_matches_jax(port, inputs, refs):
    """One row-DP pretrain step (16 rows over 4 ranks) against JAX's
    ``make_dp_pointwise_step``."""
    p2, loss = refs["dp_pointwise"]
    params = inputs["pw_params"]
    got = port.result()["dp"]["pointwise"]
    assert got["loss"] == pytest.approx(float(loss), rel=1e-4)
    ref = params_from_flax(_np_tree(p2))
    before = params_from_flax(params)
    for name, v in got["params"].items():
        if name.startswith("collision_head."):
            # outside this loss: torch gives it no gradient and Adam leaves
            # it; optax gives it a zero gradient that its weight decay
            # moves (a standing difference of every port step)
            np.testing.assert_array_equal(v, before[name].numpy())
            continue
        np.testing.assert_allclose(v, ref[name].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_dp_pointwise_step_dropout_matches_single_device(port, inputs):
    """The row-DP pretrain step with live dropout (p = 0.25) against the
    port's single-device step from the same generator seed: the ranks draw
    each mask at the whole batch's shape and keep their rows, so the masks
    are one device's.  (JAX's masks come from another generator, so the
    reference here is the port's own single-device step.)"""
    got = port.result()["dp"]
    cfg = PIMLConfig(**dict(DP_CFG, dropout=inputs["pw_dropout"]))
    model = build_model(ModelSpec.from_config(cfg))
    model.load_state_dict(params_from_flax(inputs["pw_params"]))
    opt = make_optimizer(cfg, model.parameters())
    ped, obs, self_f, labels = (torch.from_numpy(inputs["pw"][k]) for k in
                                ("ped", "obs", "self_f", "labels"))
    out = model(ped, obs, self_f,
                torch.Generator().manual_seed(inputs["pw_seed"]))
    loss = ((out.pred_acc - labels[:, 4:6]) ** 2).sum()
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    dp = got["pointwise_dropout"]
    # dropout is live: the loss is not the dropout-free step's
    assert dp["loss"] != pytest.approx(got["pointwise"]["loss"], rel=1e-3)
    # the same masks: the loss to rtol 1e-5 (sums over 4 ranks' rows),
    # parameters as in the JAX comparison (rtol 1e-4 / atol 1e-5)
    assert dp["loss"] == pytest.approx(loss.item(), rel=1e-5)
    for name, v in model.state_dict().items():
        np.testing.assert_allclose(dp["params"][name], v.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_trainer_finetune_dp_matches_single_device(port, inputs, tmp_path):
    """``Trainer.finetune`` with ``n_devices=4`` (one channel a rank)
    against the port's single-device finetune on the same batches."""
    cfg = PIMLConfig(**{**TRAINER_CFG, "save_dir": str(tmp_path)})

    def gc(frames):
        arrays = dict(inputs["gc_arrays"])
        for key in T_KEYED:
            arrays[key] = arrays[key][slice(*frames)]
        return make_time_indexed(cfg, Scene.from_arrays(arrays, device="cpu"))

    ch = to_channeled(gc(inputs["trainer_frames"]), cfg.valid_steps,
                      "slice").slice_channels(inputs["trainer_windows"])
    batches = channel_batches([ch], cfg.ft_batch_size,
                              np.random.RandomState(cfg.seed), shuffle=True)
    logger = MetricLogger(stream=open(os.devnull, "w"))
    state = Trainer(cfg, logger).finetune(
        batches, [gc(inputs["trainer_valid_frames"])],
        pretrained=load_fixture(PRETRAINED))
    got = port.result()["trainer"]
    assert got["wrote"]                       # rank 0's checkpoints
    assert got["best_val"] == pytest.approx(state.best_val, rel=1e-3)
    train = [r["train_loss"] for r in logger.records if "train_loss" in r]
    np.testing.assert_allclose(got["train_loss"], train, rtol=1e-4)
    for name, v in got["params"].items():
        np.testing.assert_allclose(v, state.params[name].numpy(), rtol=5e-4,
                                   atol=5e-5, err_msg=name)


# ---------------------------------------------------------------------------
# the agent-sharded eval rollout
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def single_rollout(inputs):
    cfg = PIMLConfig(**ROLL_CFG)
    arrays = dict(inputs["gc_arrays"])
    for key in T_KEYED:
        arrays[key] = arrays[key][:inputs["roll_frames"]]
    data = make_time_indexed(cfg, Scene.from_arrays(arrays, device="cpu"))
    model = build_model(ModelSpec.from_config(cfg))
    model.load_state_dict(load_fixture())
    model.eval()
    res = eval_rollout(model, engine_config(
        cfg, retire=True, track_collisions=False, track_labels=False),
        data, cfg.skip_frames)
    metrics = evaluate_rollouts(model, cfg, [data], test_flag=True)
    return data, res, metrics


@pytest.mark.parametrize("route", ["ring", "banded"])
def test_sharded_eval_rollout_matches_single_device(port, single_rollout,
                                                    route):
    """``eval_rollout`` with ``shard_agents`` over 4 ranks (337 agents
    padded to 340): the ring route (under the N² gate), and the sharded K2
    route (gate lowered on the ranks), against the single-device
    rollout."""
    data, ref, _ = single_rollout
    pos, mask, calls = port.result()["rollouts"][route][:3]
    n = data.num_pedestrians
    assert pos.shape[1] == 340
    assert np.isnan(pos[:, n:]).all() and not mask[:, n:].any()
    np.testing.assert_array_equal(mask[:, :n], ref.mask_p.numpy())
    np.testing.assert_allclose(np.nan_to_num(pos[:, :n]),
                               np.nan_to_num(ref.position.numpy()),
                               rtol=0, atol=1e-4)
    frames = data.num_frames - 25
    assert calls == (0 if route == "ring" else frames)
    if route == "banded":
        assert port.result()["rollouts"]["banded"][3] < frames   # mostly exact


def test_sharded_evaluate_rollouts_matches_single_device(port,
                                                         single_rollout):
    _, _, ref = single_rollout
    got = port.result()["rollouts"]["metrics"]
    for key in ("loss", "mse", "mae", "collision", "hard_collision"):
        assert got[key] == pytest.approx(getattr(ref, key), rel=1e-4), key
    assert got["ot"] == pytest.approx(ref.ot, rel=1e-4, abs=1e-5)
    assert got["mmd"] == pytest.approx(ref.mmd, rel=1e-4, abs=1e-6)


# ---------------------------------------------------------------------------
# sharded OT / MMD
# ---------------------------------------------------------------------------

def _ref_clouds(x, y, mx, my, mesh4):
    x, y, mx, my = (jnp.asarray(a) for a in (x, y, mx, my))
    return (
        (float(jax.jit(lambda *a: jax_metrics_shard.sharded_sinkhorn(
            *a, mesh4))(x, y, mx, my)), float(sinkhorn_masked(x, y, mx, my))),
        (float(jax.jit(lambda *a: jax_metrics_shard.sharded_mmd(
            *a, mesh4))(x, y, mx, my)), float(mmd_masked(x, y, mx, my))))


@pytest.mark.parametrize("case", ["ragged"])
def test_sharded_sinkhorn_and_mmd_match_jax(port, refs, case):
    """91 × 85 points do not divide 4 ranks: padded rows carry no mass.
    Against JAX's sharded and single-device values."""
    ot_refs, mmd_refs = refs["clouds"][case]
    ot_t, mmd_t = port.result()["metrics"][case]
    for ref in ot_refs:
        assert ot_t == pytest.approx(ref, rel=1e-4)
    for ref in mmd_refs:
        assert mmd_t == pytest.approx(ref, rel=1e-4, abs=1e-6)


def _ref_time_masked(frames, mesh4):
    p, q, mask = (jnp.asarray(frames[k]) for k in ("p", "q", "mask"))
    return (float(jax.jit(lambda a, b, c: jax_metrics_shard
                          .sharded_ot_with_time_mask(a, b, c, mesh4))(
                p, q, mask)),
            float(jax.jit(lambda a, b, c: jax_metrics_shard
                          .sharded_mmd_with_time_mask(a, b, c, mesh4))(
                p, q, mask)))


def test_sharded_time_masked_metrics_match_jax(port, refs):
    """Frame loops with JAX's skip of frames of ≤ 1 present agent."""
    ot_j, mmd_j = refs["time_masked"]
    ot_t, mmd_t = port.result()["metrics"]["time_masked"]
    assert ot_t == pytest.approx(ot_j, rel=1e-4)
    assert mmd_t == pytest.approx(mmd_j, rel=1e-4, abs=1e-6)


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

def test_tp_specs_match_jax(inputs):
    """The Megatron alternation, read off the converter's flax names: every
    ``state_dict`` entry's spec is the transpose of JAX's for its leaf."""
    params = inputs["tp_params"]
    mesh = Mesh(np.array(jax.devices()[:RANKS]), ("tp",))
    ref = jax_tp.tp_param_shardings(params, mesh)
    flat = {}
    jax.tree_util.tree_map_with_path(
        lambda path, s: flat.__setitem__(
            "/".join(jax_tp._path_keys(path)), tuple(s.spec)), ref,
        is_leaf=lambda s: hasattr(s, "spec"))
    cfg = PIMLConfig(**TP_CFG)
    model = build_model(ModelSpec.from_config(cfg))
    model.load_state_dict(params_from_flax(params))
    got = tensor_parallel.tp_param_specs(model, RANKS)
    assert len(got) == len(flat)
    for name, spec in got.items():
        *mods, leaf = name.split(".")
        key = "/".join(["params", *mods,
                        "kernel" if leaf == "weight" else leaf])
        want = flat[key]
        want = tuple(want[::-1]) if leaf == "weight" else tuple(want)
        assert spec + (None,) * (len(want) - len(spec)) == want or \
            (spec == () and all(s is None for s in want)), (name, spec, want)
    assert got["ped_encoder.dense_0.weight"] == ("tp", None)   # column
    assert got["ped_encoder.dense_1.weight"] == (None, "tp")   # row
    assert got["ped_predictor.dense_0.weight"] == ()           # 2 wide


def test_tp_forward_matches_jax(port, inputs):
    """``make_tp_apply`` on a 2 × 2 mesh's tp axis against JAX's
    replicated forward of the same weights."""
    model = jax_build(JaxSpec.from_config(JaxConfig(**TP_CFG)))
    x = inputs["tp_inputs"]
    ref = np.asarray(model.apply(inputs["tp_params"], x["ped"], x["obs"],
                                 x["self_f"]).pred_acc)
    got = port.result()["tp"]
    np.testing.assert_allclose(got["forward"], ref, rtol=1e-5, atol=1e-6)
    # the split layers hold half the weight on each rank
    assert got["shapes"]["ped_encoder.dense_0.weight"] == (32, 6)
    assert got["shapes"]["ped_encoder.dense_1.weight"] == (64, 32)


def _ref_tp_dp(inputs):
    jcfg = JaxConfig(**DP_CFG)
    model = jax_build_finetune(JaxSpec.from_config(jcfg))
    tx = jax_optimizer(jcfg, finetune=True)
    mesh = Mesh(np.array(jax.devices()[:RANKS]).reshape(2, 2), ("dp", "tp"))
    p_tp, shardings = jax_tp.shard_params_tp(inputs["dp_params"], mesh)
    o_tp = jax.jit(tx.init)(p_tp)
    b_tp = jax_sharding.shard_channeled_batch(
        _jax_batch(inputs["dp_batch"]), mesh, axis="dp")
    step = jax_tp.make_tp_dp_finetune_step(
        jcfg, lambda p, pf, of, sf: model.apply(p, pf, of, sf), tx, mesh,
        shardings)
    losses = []
    for _ in range(3):
        p_tp, o_tp, out = step(p_tp, o_tp, b_tp)
        losses.append(float(out.loss))
    return p_tp, losses


def test_tp_dp_step_matches_jax(port, refs):
    """Three dp × tp (2 × 2) finetune steps against JAX's
    ``make_tp_dp_finetune_step`` on the same mesh shape."""
    p_tp, losses = refs["tp_dp"]
    got = port.result()["tp"]
    np.testing.assert_allclose(got["losses"], losses, rtol=2e-4)
    ref = params_from_flax(_np_tree(p_tp))
    for name, v in got["params"].items():
        np.testing.assert_allclose(v, ref[name].numpy(), rtol=5e-4,
                                   atol=5e-5, err_msg=name)

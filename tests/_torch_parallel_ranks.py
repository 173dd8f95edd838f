"""The ranks' side of tests/test_torch_parallel.py.

A spawned rank imports this module by name, so it imports only torch,
numpy and the port (never JAX: the test module does).  :func:`run_all`
runs every case on one rank of a 4-rank gloo group on the CPU and returns
numpy results; the test module holds them to the JAX package.
"""

import importlib
import os

import numpy as np
import torch

from piml_tpu_torch import parallel
from piml_tpu_torch.config import PIMLConfig
from piml_tpu_torch.data import (ChanneledData, channel_batches,
                                 make_time_indexed, to_channeled)
from piml_tpu_torch.data.views import pad_agents
from piml_tpu_torch.engine import engine_config, eval_rollout, evaluate_rollouts
from piml_tpu_torch.models import (PRETRAINED, ModelSpec, build_finetune_model,
                                   build_model, load_fixture,
                                   params_from_flax)
from piml_tpu_torch.ops import banded
from piml_tpu_torch.parallel import metrics_shard, sharding, tensor_parallel
from piml_tpu_torch.physics import NeighborConfig, heading_direction
from piml_tpu_torch.scene import Scene
from piml_tpu_torch.train.trainer import (MetricLogger, Trainer,
                                          make_optimizer)

RANKS = 4
# the module, not the function of that name that the package exports
rollout_mod = importlib.import_module("piml_tpu_torch.engine.rollout")


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _np(x):
    return x.detach().cpu().numpy()


def _features(mesh, scenes):
    cfg = NeighborConfig(use_pallas_topk=False, use_grid_topk=False)
    out = {}
    for name, sc in scenes.items():
        args = [_t(sc[k]) for k in ("p", "v", "a", "dest", "obs")]
        before = banded.KERNEL.fallbacks
        out[name] = dict(
            ring=[_np(x) for x in parallel.sharded_relative_features(
                *args, cfg, mesh)],
            banded=[_np(x) for x in parallel.sharded_banded_features(
                *args, cfg, mesh)],
            fallbacks=banded.KERNEL.fallbacks - before)
        v0 = torch.where(torch.isnan(args[1]), 0.0, args[1])
        state = torch.cat([args[0], v0, torch.where(
            torch.isnan(args[2]), 0.0, args[2])], dim=-1)
        d, rows = parallel.ring_topk_neighbors(
            state, heading_direction(v0, time_axis=False), cfg.topk_ped,
            cfg.sight_angle_ped, mesh)
        out[name]["ring_topk"] = (_np(d), _np(rows))
    return out


def _dp_steps(mesh, inp):
    cfg = PIMLConfig(**inp["dp_cfg"])
    batch = ChanneledData(**{k: _t(v) for k, v in inp["dp_batch"].items()},
                          meta_data={"time_unit": cfg.time_unit})
    model = build_finetune_model(ModelSpec.from_config(cfg))
    model.load_state_dict(params_from_flax(inp["dp_params"]))
    opt = make_optimizer(cfg, model, finetune=True)
    step = parallel.make_dp_finetune_step(cfg, model, opt, mesh)
    out = step(batch)
    ft = dict(loss=float(out.loss), terms=[float(t) for t in out],
              params={k: _np(v) for k, v in model.state_dict().items()},
              local_channels=sharding.shard_channeled_batch(
                  batch, mesh).num_channels)

    pre = build_model(ModelSpec.from_config(cfg))
    pre.load_state_dict(params_from_flax(inp["pw_params"]))
    opt = make_optimizer(cfg, pre.parameters())
    pstep = parallel.make_dp_pointwise_step(cfg, pre, opt, mesh)
    loss = pstep(*(_t(inp["pw"][k]) for k in ("ped", "obs", "self_f",
                                              "labels")))
    pw = dict(loss=float(loss),
              params={k: _np(v) for k, v in pre.state_dict().items()})

    # live dropout: the same generator state on every rank
    cfg_d = cfg.replace(dropout=inp["pw_dropout"])
    pre = build_model(ModelSpec.from_config(cfg_d))
    pre.load_state_dict(params_from_flax(inp["pw_params"]))
    opt = make_optimizer(cfg_d, pre.parameters())
    pstep = parallel.make_dp_pointwise_step(cfg_d, pre, opt, mesh)
    loss = pstep(*(_t(inp["pw"][k]) for k in ("ped", "obs", "self_f",
                                              "labels")),
                 generator=torch.Generator().manual_seed(inp["pw_seed"]))
    pw_d = dict(loss=float(loss),
                params={k: _np(v) for k, v in pre.state_dict().items()})
    return dict(finetune=ft, pointwise=pw, pointwise_dropout=pw_d)


def _gc_data(inp, cfg, frames):
    arrays = dict(inp["gc_arrays"])
    for key in inp["gc_t_keyed"]:
        arrays[key] = arrays[key][slice(*frames)]
    return make_time_indexed(cfg, Scene.from_arrays(arrays, device="cpu"))


def _trainer(inp):
    """``Trainer.finetune(n_devices=4)`` on the windows the test's
    single-device run uses."""
    # every rank names the same directory: only rank 0 writes
    save_dir = os.path.join(inp["trainer_dir"], "dp")
    cfg = PIMLConfig(**{**inp["trainer_cfg"], "save_dir": save_dir,
                        "n_devices": RANKS})
    data = _gc_data(inp, cfg, inp["trainer_frames"])
    ch = to_channeled(data, cfg.valid_steps, "slice").slice_channels(
        inp["trainer_windows"])
    batches = channel_batches([ch], cfg.ft_batch_size,
                              np.random.RandomState(cfg.seed), shuffle=True)
    valid = _gc_data(inp, cfg, inp["trainer_valid_frames"])
    logger = MetricLogger(stream=open(os.devnull, "w"))
    state = Trainer(cfg, logger).finetune(
        batches, [valid], pretrained=load_fixture(PRETRAINED))
    return dict(best_val=state.best_val,
                params={k: _np(v) for k, v in state.params.items()},
                train_loss=[r["train_loss"] for r in logger.records
                            if "train_loss" in r],
                wrote=os.path.exists(save_dir))


def _rollouts(mesh, inp):
    cfg = PIMLConfig(**inp["roll_cfg"])
    data = _gc_data(inp, cfg, (0, inp["roll_frames"]))
    model = build_model(ModelSpec.from_config(cfg))
    model.load_state_dict(load_fixture())
    model.eval()
    ecfg = engine_config(cfg, retire=True, track_collisions=False,
                         track_labels=False, shard_agents=True)
    padded = pad_agents(data, RANKS)
    out = {}
    calls = banded.KERNEL.sharded_calls
    ring = eval_rollout(model, ecfg, padded, cfg.skip_frames, mesh=mesh)
    out["ring"] = (_np(ring.position), _np(ring.mask_p),
                   banded.KERNEL.sharded_calls - calls)
    # the sharded K2 route, engaged below its N² gate
    gate = rollout_mod.engine_uses_grid
    rollout_mod.engine_uses_grid = lambda n, ncfg: ncfg.use_grid_topk
    try:
        calls = banded.KERNEL.sharded_calls
        fb = banded.KERNEL.fallbacks
        band = eval_rollout(model, ecfg, padded, cfg.skip_frames, mesh=mesh)
        out["banded"] = (_np(band.position), _np(band.mask_p),
                         banded.KERNEL.sharded_calls - calls,
                         banded.KERNEL.fallbacks - fb)
    finally:
        rollout_mod.engine_uses_grid = gate
    m = evaluate_rollouts(model, cfg, [data], test_flag=True, mesh=mesh)
    out["metrics"] = {k: getattr(m, k) for k in (
        "loss", "mse", "mae", "ot", "mmd", "collision", "hard_collision")}
    return out


def _metrics(mesh, inp):
    out = {}
    for name, (x, y, mx, my) in inp["clouds"].items():
        x, y, mx, my = (_t(a) for a in (x, y, mx, my))
        out[name] = (float(metrics_shard.sharded_sinkhorn(x, y, mx, my,
                                                          mesh)),
                     float(metrics_shard.sharded_mmd(x, y, mx, my, mesh)))
    p, q, mask = (_t(inp["frames"][k]) for k in ("p", "q", "mask"))
    out["time_masked"] = (
        float(parallel.sharded_ot_with_time_mask(p, q, mask, mesh)),
        float(parallel.sharded_mmd_with_time_mask(p, q, mask, mesh)))
    return out


def _tp(inp):
    cfg = PIMLConfig(**inp["tp_cfg"])
    mesh = parallel.make_mesh((2, 2), ("dp", "tp"), device="cpu")
    model = build_model(ModelSpec.from_config(cfg))
    model.load_state_dict(params_from_flax(inp["tp_params"]))
    tp_model = parallel.make_tp_apply(model, mesh)
    ped, obs, self_f = (_t(inp["tp_inputs"][k])
                        for k in ("ped", "obs", "self_f"))
    fwd = _np(tp_model(ped, obs, self_f).pred_acc)
    shapes = {k: tuple(v.shape) for k, v in tp_model.state_dict().items()}

    cfg = PIMLConfig(**inp["dp_cfg"])
    ft = build_finetune_model(ModelSpec.from_config(cfg))
    ft.load_state_dict(params_from_flax(inp["dp_params"]))
    tp_ft, _ = tensor_parallel.shard_params_tp(ft, mesh)
    opt = make_optimizer(cfg, tp_ft, finetune=True)
    step = parallel.make_tp_dp_finetune_step(cfg, tp_ft, opt, mesh)
    batch = ChanneledData(**{k: _t(v) for k, v in inp["dp_batch"].items()},
                          meta_data={"time_unit": cfg.time_unit})
    losses = [float(step(batch).loss) for _ in range(3)]
    full = tensor_parallel.gather_params_tp(tp_ft)
    return dict(forward=fwd, shapes=shapes, losses=losses,
                params={k: _np(v) for k, v in full.items()})


def run_all(rank, device, inp):
    """Every case on this rank; the results of rank 0 go to the test, the
    others' are compared with rank 0's."""
    mesh = parallel.make_mesh(RANKS, "ap", device="cpu")
    out = dict(features=_features(mesh, inp["scenes"]),
               metrics=_metrics(mesh, inp),
               rollouts=_rollouts(mesh, inp))
    dp_mesh = parallel.make_mesh(RANKS, "dp", device="cpu")
    out["dp"] = _dp_steps(dp_mesh, inp)
    out["trainer"] = _trainer(inp)
    out["tp"] = _tp(inp)
    return out

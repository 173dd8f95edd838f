"""Evaluation rollouts and their metrics.

Counterpart of ``piml_tpu/engine/simulator.py`` (reference:
src/models/simulators.py ``get_multiple_rollouts`` :556 and
``test_multiple_rollouts`` :465).  The differentiable training rollout is
not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from piml_tpu_torch.config import PIMLConfig
from piml_tpu_torch.data.views import TimeIndexedData, neighbor_config
from piml_tpu_torch.engine.rollout import (
    EngineConfig,
    init_state,
    rollout,
    spawn_frames_from_scene,
)
from piml_tpu_torch.metrics import collision_count, mae_with_time_mask


def engine_config(cfg: PIMLConfig, *, retire: bool, track_collisions: bool,
                  track_labels: bool) -> EngineConfig:
    return EngineConfig(
        neighbor=neighbor_config(cfg),
        time_unit=cfg.time_unit,
        lagged=cfg.compat_lagged_euler,
        retire_on_arrival=retire,
        track_collisions=track_collisions,
        collision_threshold=cfg.collision_threshold,
        track_collision_labels=track_labels,
    )


class RolloutResult(NamedTuple):
    position: torch.Tensor   # (T, N, 2) — GT before t_start, predictions after
    velocity: torch.Tensor
    acceleration: torch.Tensor
    mask_p: torch.Tensor     # (T, N)


@torch.inference_mode()
def eval_rollout(model: Callable, ecfg: EngineConfig, data: TimeIndexedData,
                 t_start: int) -> RolloutResult:
    """Closed-loop rollout from ``t_start`` with ground-truth teleport-in
    and arrival retirement; returns full dense trajectories."""
    state = init_state(
        p=data.position[t_start], v=data.velocity[t_start],
        a=data.acceleration[t_start], dest=data.destination[t_start],
        dest_idx=data.dest_idx[t_start], ped_f=data.ped_features[t_start],
        obs_f=data.obs_features[t_start],
        self_f=data.self_features[t_start])
    spawns = spawn_frames_from_scene(
        data.position, data.velocity, data.acceleration, data.destination,
        data.dest_idx, data.self_features, data.mask_p, data.mask_p_pred,
        t_start)
    take = type(spawns)(*(x[: data.num_frames - t_start] for x in spawns))
    _, outs = rollout(model, ecfg, state, take, data.waypoints,
                      data.dest_num, data.obstacles,
                      data.desired_speed[:, None])

    def prefix(gt, roll):
        return torch.cat([gt[:t_start], roll], dim=0)

    return RolloutResult(
        position=prefix(data.position, outs.p),
        velocity=prefix(data.velocity, outs.v),
        acceleration=prefix(data.acceleration, outs.a),
        mask_p=prefix(data.mask_p, outs.mask),
    )


def post_process(data: TimeIndexedData, pred_pos: torch.Tensor,
                 pred_mask_p: torch.Tensor,
                 mask_p: torch.Tensor) -> torch.Tensor:
    """Clamp agents that arrived early in the prediction to their final
    waypoint (reference: simulators.py:443-463)."""
    final_idx = torch.clamp_min(data.dest_num - 1, 0).long()
    agent_ids = torch.arange(data.waypoints.shape[1],
                             device=data.waypoints.device)
    final_wp = data.waypoints[final_idx, agent_ids]            # N, 2
    fix = ((mask_p == 1) & (pred_mask_p == 0))[..., None]
    return torch.where(fix, final_wp[None], pred_pos)


@dataclasses.dataclass
class RolloutMetrics:
    loss: float
    mse: float
    mae: float
    ot: Optional[float]
    mmd: Optional[float]
    collision: float
    hard_collision: float


@torch.inference_mode()
def evaluate_rollouts(model: Callable, cfg: PIMLConfig, datasets, *,
                      test_flag: bool = True) -> RolloutMetrics:
    """Rollout + metrics over a list of scenes (reference:
    simulators.py:465-554, list branch).

    Reports ``loss``, ``mse``, ``mae`` (per predictable row) and the soft /
    hard ``collision`` counts.  ``ot`` and ``mmd`` are None: Sinkhorn OT
    and MMD are not ported yet."""
    ecfg = engine_config(cfg, retire=True, track_collisions=False,
                         track_labels=False)
    if isinstance(datasets, TimeIndexedData):
        datasets = [datasets]

    mae_sum = mse_sum = coll_sum = hard_sum = loss_sum = 0.0
    n_rows = 0
    for data in datasets:
        res = eval_rollout(model, ecfg, data, cfg.skip_frames)
        t0 = cfg.skip_frames
        coll = collision_count(res.position[t0:], cfg.collision_threshold)
        hard = collision_count(res.position[t0:],
                               cfg.collision_threshold / 2)
        p_post = post_process(data, res.position, res.mask_p,
                              data.mask_p_pred)
        labels = data.labels[..., :2]
        m = (data.mask_p_pred == 1)[..., None]
        mse = torch.where(m, (p_post - labels) ** 2, 0.0).sum()
        rows = (data.mask_p_pred == 1).sum()
        scal = [coll, hard, mse, rows]
        if test_flag:
            scal.append(mae_with_time_mask(p_post, labels, data.mask_p_pred,
                                           "sum"))
        # one host sync per scene
        vals = torch.stack([s.to(torch.float64) for s in scal]).tolist()
        coll, hard, mse = vals[0], vals[1], vals[2]
        coll_sum += coll
        hard_sum += hard
        loss = mse
        if test_flag:
            mae_sum += vals[4]
        else:
            loss = loss + cfg.val_coll_weight * (coll + hard)
        n_rows += int(vals[3])
        loss_sum += loss
        mse_sum += mse

    n_rows = max(n_rows, 1)
    return RolloutMetrics(
        loss=loss_sum / n_rows, mse=mse_sum / n_rows, mae=mae_sum / n_rows,
        ot=None, mmd=None, collision=coll_sum, hard_collision=hard_sum)

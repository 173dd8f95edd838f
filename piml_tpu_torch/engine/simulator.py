"""Evaluation rollouts, their metrics, and the training loss.

Counterpart of ``piml_tpu/engine/simulator.py`` (reference:
src/models/simulators.py ``get_multiple_rollouts`` :556,
``test_multiple_rollouts`` :465 and ``test_multiple_rollouts_for_training``
:659): thin assemblies over the rollout engine.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from piml_tpu_torch.config import PIMLConfig
from piml_tpu_torch.data.views import (ChanneledData, TimeIndexedData,
                                       neighbor_config, pad_agents)
from piml_tpu_torch.engine.rollout import (
    EngineConfig,
    SpawnFrame,
    batched_rollout,
    init_state,
    rollout,
    spawn_frames_from_scene,
)
from piml_tpu_torch.metrics import (collision_count, mae_with_time_mask,
                                    mmd_with_time_mask, ot_with_time_mask)
from piml_tpu_torch.physics import collision_detection_single_frame
from piml_tpu_torch.physics.features import _GATE
from piml_tpu_torch.train import losses
from piml_tpu_torch.utils.profiling import annotate


def engine_config(cfg: PIMLConfig, *, retire: bool, track_collisions: bool,
                  track_labels: bool,
                  shard_agents: bool = False) -> EngineConfig:
    return EngineConfig(
        neighbor=neighbor_config(cfg),
        time_unit=cfg.time_unit,
        lagged=cfg.compat_lagged_euler,
        retire_on_arrival=retire,
        track_collisions=track_collisions,
        collision_threshold=cfg.collision_threshold,
        track_collision_labels=track_labels,
        shard_agents=shard_agents,
    )


class RolloutResult(NamedTuple):
    position: torch.Tensor   # (T, N, 2) — GT before t_start, predictions after
    velocity: torch.Tensor
    acceleration: torch.Tensor
    mask_p: torch.Tensor     # (T, N)


@torch.inference_mode()
def eval_rollout(model: Callable, ecfg: EngineConfig, data: TimeIndexedData,
                 t_start: int, mesh=None,
                 mesh_axis: str = "ap") -> RolloutResult:
    """Closed-loop rollout from ``t_start`` with ground-truth teleport-in
    and arrival retirement; returns full dense trajectories.

    With ``ecfg.shard_agents`` and a ``mesh``, every frame's pair pass runs
    agent-sharded over ``mesh_axis`` (N must divide the axis: pad with
    ``data.views.pad_agents``); every rank passes the whole scene and
    gets the whole result."""
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
                      data.desired_speed[:, None], mesh=mesh,
                      mesh_axis=mesh_axis)

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
    ot: float
    mmd: float
    collision: float
    hard_collision: float


@torch.inference_mode()
def evaluate_rollouts(model: Callable, cfg: PIMLConfig, datasets, *,
                      test_flag: bool = True, mesh=None,
                      mesh_axis: str = "ap") -> RolloutMetrics:
    """Rollout + metrics over a list of scenes (reference:
    simulators.py:465-554, list branch).

    Reports ``loss``, ``mse``, ``mae`` (per predictable row), ``ot`` and
    ``mmd`` (per frame with predictable agents; ``mae``, ``ot`` and
    ``mmd`` under ``test_flag`` only, 0 otherwise) and the soft / hard
    ``collision`` counts.  One host read per scene.

    ``mesh``: agent-shard each rollout's pair pass over ``mesh_axis``; the
    scenes are padded to the axis with inert agents (``pad_agents``), which
    leave every metric unchanged."""
    ecfg = engine_config(cfg, retire=True, track_collisions=False,
                         track_labels=False, shard_agents=mesh is not None)
    if isinstance(datasets, TimeIndexedData):
        datasets = [datasets]

    mae_sum = mse_sum = ot_sum = mmd_sum = 0.0
    coll_sum = hard_sum = loss_sum = 0.0
    n_rows = n_frames = 0
    for data in datasets:
        if mesh is not None:
            from piml_tpu_torch.parallel.sharding import axis_size

            data = pad_agents(data, axis_size(mesh, mesh_axis))
        res = eval_rollout(model, ecfg, data, cfg.skip_frames, mesh=mesh,
                           mesh_axis=mesh_axis)
        t0 = cfg.skip_frames
        coll = collision_count(res.position[t0:], cfg.collision_threshold)
        hard = collision_count(res.position[t0:],
                               cfg.collision_threshold / 2)
        mask_pred = data.mask_p_pred
        p_post = post_process(data, res.position, res.mask_p, mask_pred)
        labels = data.labels[..., :2]
        m = (mask_pred == 1)[..., None]
        mse = torch.where(m, (p_post - labels) ** 2, 0.0).sum()
        rows = (mask_pred == 1).sum()
        frames = (mask_pred.sum(dim=-1) > 0).sum()
        scal = [coll, hard, mse, rows, frames]
        if test_flag:
            scal += [mae_with_time_mask(p_post, labels, mask_pred, "sum"),
                     ot_with_time_mask(p_post, labels, mask_pred, "sum"),
                     mmd_with_time_mask(p_post, labels, mask_pred, "sum")]
        # one host sync per scene
        vals = torch.stack([s.to(torch.float64) for s in scal]).tolist()
        coll, hard, mse = vals[0], vals[1], vals[2]
        coll_sum += coll
        hard_sum += hard
        loss = mse
        if test_flag:
            mae_sum += vals[5]
            ot_sum += vals[6]
            mmd_sum += vals[7]
        else:
            loss = loss + cfg.val_coll_weight * (coll + hard)
        n_rows += int(vals[3])
        n_frames += int(vals[4])
        loss_sum += loss
        mse_sum += mse

    n_rows = max(n_rows, 1)
    n_frames = max(n_frames, 1)
    return RolloutMetrics(
        loss=loss_sum / n_rows, mse=mse_sum / n_rows, mae=mae_sum / n_rows,
        ot=ot_sum / n_frames, mmd=mmd_sum / n_frames,
        collision=coll_sum, hard_collision=hard_sum)


# ---------------------------------------------------------------------------
# differentiable training rollout (simulators.py:659-832)
# ---------------------------------------------------------------------------

class TrainingRolloutLoss(NamedTuple):
    loss: torch.Tensor
    mse_loss: torch.Tensor
    collision_loss: torch.Tensor
    hard_collision_loss: torch.Tensor
    collision_pred_loss: torch.Tensor
    collision_pred_acc: torch.Tensor
    reg_loss: torch.Tensor
    collision_count: torch.Tensor
    hard_collision_count: torch.Tensor


def _channel_spawns(batch: ChanneledData) -> SpawnFrame:
    """Each window's teleport-in schedule from its own frame 0,
    channel-leading ``(C, T, ...)``."""
    time_major = spawn_frames_from_scene(
        *(x.movedim(1, 0) for x in (
            batch.position, batch.velocity, batch.acceleration,
            batch.destination, batch.dest_idx, batch.self_features,
            batch.mask_p, batch.mask_p_pred)), 0)
    return SpawnFrame(*(x.movedim(0, 1) for x in time_major))


def training_rollout_loss(model: Callable, cfg: PIMLConfig,
                          batch: ChanneledData,
                          generator: Optional[torch.Generator] = None, *,
                          seeds: Optional[torch.Tensor] = None,
                          total: Optional[Callable] = None
                          ) -> TrainingRolloutLoss:
    """The finetune loss through the differentiable rollout of every
    window channel (simulators.py:781-832): time-decayed rollout MSE,
    collision-gated perpendicular penalties (v0 / v2 with the abnormal
    mask), the optional teacher acceleration MSE (reverse decay), BCE of
    the collision head over live slots, and L1 message regularisation.
    Call ``.loss.backward()`` for the gradients.

    ``generator``: when given, dropout is live — one seed per frame and
    channel is drawn from it before the rollout (the reference finetunes
    under ``model.train()``, simulators.py:295).  ``seeds``: the ``(C, T)``
    seed table itself, in place of ``generator`` (a data-parallel rank's
    rows of the global table, ``parallel/sharding.py``).  ``total``: maps a
    count over this batch's channels to the count over every rank's
    channels (an all-reduce); the collision-head accuracy, the one term
    that divides by a count, divides by it.  Every loss term is a sum.

    Routing is the JAX package's, with "TPU" read as "CUDA tensor": at
    dense N on the card the feature pass takes the channel-batched banded
    route (``batched_rollout``'s one exactness decision per frame);
    otherwise the banded selector is off.  The port has no ``vmap``, so
    both cases run the same channel-batched loop.  ``cfg.bptt_unroll`` is
    a ``lax.scan`` unroll factor and has no meaning for a Python loop: it
    is accepted and ignored.
    """
    with annotate("step.loss"):
        C, T = batch.num_channels, batch.num_frames
        n_agents = batch.position.shape[2]
        on_card = batch.position.is_cuda
        remat = cfg.remat_features
        if remat is None:
            # the JAX package's auto policy: small batches run unrematerialized
            # on the accelerator (launch-bound), everything else rematerializes
            per_dev = C / max(cfg.n_devices, 1)
            remat = not (per_dev * n_agents <= 16384 and on_card)
        ecfg = dataclasses.replace(
            engine_config(cfg, retire=False, track_collisions=True,
                          track_labels=cfg.collision_pred_weight > 0),
            remat=remat)
        use_batched = cfg.channel_batched_bptt
        if use_batched is None:
            use_batched = (ecfg.neighbor.use_grid_topk
                           and n_agents * n_agents >= _GATE and on_card)
        if not use_batched:
            ecfg = dataclasses.replace(
                ecfg, neighbor=ecfg.neighbor._replace(use_grid_topk=False))

        if generator is not None:
            seeds = torch.randint(0, 2 ** 62, (C, T), generator=generator)
        state0 = init_state(
            batch.position[:, 0], batch.velocity[:, 0],
            batch.acceleration[:, 0], batch.destination[:, 0],
            batch.dest_idx[:, 0], batch.ped_features[:, 0],
            batch.obs_features[:, 0], batch.self_features[:, 0])
        _, outs = batched_rollout(
            model, ecfg, state0, _channel_spawns(batch), batch.waypoints,
            batch.dest_num, batch.obstacles, batch.desired_speed[:, None],
            step_seeds=seeds)

        mask_pred = batch.mask_p_pred                                # C, T, N
        # frames with no predictable agents record nothing (simulators.py:707)
        frame_active = (mask_pred.sum(dim=-1, keepdim=True) > 0).to(
            outs.p.dtype)                                            # C, T, 1
        pred_rows = (mask_pred == 1)[..., None]

        def masked(x):
            x = torch.where(pred_rows, x, 0.0)
            return torch.where(torch.isnan(x), 0.0, x)

        p_res = masked(outs.p)
        labels_p = masked(batch.labels[..., :2])
        mse = losses.multiple_rollout_mse_loss(p_res, labels_p, cfg.time_decay,
                                               "sum")
        loss = mse

        reg = (outs.msg_l1 * frame_active[..., 0]).sum() * cfg.reg_weight
        if cfg.reg_weight > 0:
            loss = loss + reg

        collisions = outs.collisions * frame_active
        hard_collisions = outs.hard_collisions * frame_active

        # label collisions from the ground-truth next-step positions
        lab_pos = batch.labels[..., :2]
        with annotate("contacts.labels", device=True):
            label_coll = collision_detection_single_frame(
                lab_pos, cfg.collision_threshold) * frame_active
        with annotate("contacts.labels", device=True):
            label_hard = collision_detection_single_frame(
                lab_pos, cfg.collision_threshold / 2) * frame_active
        if cfg.new_collision_loss_flag:
            any_lc = label_coll.sum(dim=-2, keepdim=True) > 0        # C, 1, N
            any_lh = label_hard.sum(dim=-2, keepdim=True) > 0
            collisions = torch.where(any_lc, 0.0, collisions)
            hard_collisions = torch.where(any_lh, 0.0, hard_collisions)

        zero = torch.zeros((), device=outs.p.device)
        coll_loss = hard_loss = zero
        if cfg.collision_loss_weight > 0:
            abnormal = (batch.abnormal_mask
                        if cfg.collision_loss_version == "v2" else None)
            coll_loss = losses.multiple_rollout_collision_loss(
                p_res, labels_p, cfg.time_decay, collisions, "sum", abnormal
            ) * cfg.collision_loss_weight
            hard_loss = losses.multiple_rollout_collision_loss(
                p_res, labels_p, cfg.time_decay, hard_collisions, "sum",
                abnormal
            ) * cfg.collision_loss_weight * cfg.hard_collision_penalty
            loss = loss + coll_loss + hard_loss

        if cfg.teacher_weight > 0:
            a_mse = losses.multiple_rollout_mse_loss(
                masked(outs.a), masked(batch.labels[..., 4:6]), cfg.time_decay,
                "sum", reverse=True)
            loss = loss + a_mse * cfg.teacher_weight

        cp_loss = cp_acc = zero
        if cfg.collision_pred_weight > 0:
            # only live slots reach the BCE: the reference's dynamic tensors
            # hold live agents only (simulators.py:781-832)
            live = outs.mask * frame_active                          # C, T, N
            pred_c = outs.coll_pred * live[..., None]
            true_c = outs.true_coll * live[..., None]
            cp_loss = losses.binary_cross_entropy(
                pred_c, true_c, "sum") * cfg.collision_pred_weight
            n_live = live.sum() if total is None else total(live.sum())
            n_live = torch.clamp_min(n_live, 1.0) * outs.coll_pred.shape[-1]
            cp_acc = ((torch.round(pred_c) == true_c).to(pred_c.dtype)
                      * live[..., None]).sum() / n_live
            loss = loss + cp_loss

        return TrainingRolloutLoss(
            loss=loss, mse_loss=mse, collision_loss=coll_loss,
            hard_collision_loss=hard_loss, collision_pred_loss=cp_loss,
            collision_pred_acc=cp_acc, reg_loss=reg,
            collision_count=collisions.sum(),
            hard_collision_count=hard_collisions.sum())

"""The rollout engine: one step function, looped over frames.

Counterpart of ``piml_tpu/engine/rollout.py`` (reference:
src/models/simulators.py:595-652).  Per frame:

- the model predicts accelerations from the carried features;
- lagged explicit Euler: ``v' = v + a_prev·dt``, ``p' = p + v·dt``
  (``lagged=False``: ``v' = v + F·dt``, ``p' = p + v'·dt``);
- waypoints advance below 0.5 m, clamped at the last one; arrived agents
  retire to NaN (``retire_on_arrival``);
- newly appearing agents teleport in from ground truth;
- the neighbour features are rebuilt for the next frame.

The frame loop is plain Python; the banded selector's exactness flag is
read on the host once per pass.  Under ``torch.profiler`` each call, frame,
model call, feature pass and contact count is a span
(``utils/profiling.py``).  :func:`rollout` runs it under
``torch.inference_mode()`` (evaluation); :func:`batched_rollout` runs the
same step on a ``(C, N, ...)`` batch of window channels with autograd on
(the BPTT finetune), optionally checkpointing each frame.  The JAX
package's ``scan`` carries become the loop's variables; ``vmap`` over
channels becomes the leading axis of the state.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from piml_tpu_torch.physics import (
    NeighborConfig,
    collision_detection_single_frame,
    collision_label,
    heading_direction,
    relative_features,
)
from piml_tpu_torch.physics.features import _GATE, prepare_obstacle_index
from piml_tpu_torch.utils.profiling import annotate


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static rollout configuration."""

    neighbor: NeighborConfig = NeighborConfig()
    time_unit: float = 0.08
    lagged: bool = True             # reference Euler lag (simulators.py:602-604)
    retire_on_arrival: bool = True  # eval/gen: NaN out arrived agents
    track_collisions: bool = False  # per-step contact counts
    collision_threshold: float = 0.5
    track_collision_labels: bool = False  # pinnsf_bm multitask bookkeeping
    remat: bool = True              # checkpoint each frame under autograd
                                    # (batched_rollout; jax.checkpoint in
                                    # the JAX package)
    shard_agents: bool = False      # agent-sharded pair pass over a mesh
                                    # (parallel/agent_shard.py): sharded K2
                                    # when use_grid_topk and N² ≥ 2^21,
                                    # else the ring pass; N must divide the
                                    # mesh axis


@dataclasses.dataclass
class EngineState:
    """One frame's live state (agent axis N).  ``ped_f`` / ``obs_f`` /
    ``self_f`` are the next model inputs: the first step uses the
    dataset-built features (simulators.py:571-572,642-651)."""

    p: torch.Tensor          # (N, 2) NaN = absent
    v: torch.Tensor          # (N, 2)
    a: torch.Tensor          # (N, 2)
    dest: torch.Tensor       # (N, 2)
    dest_idx: torch.Tensor   # (N,) int32
    hist_v: torch.Tensor     # (N, 2*h)
    ped_f: torch.Tensor      # (N, k1, 6)
    obs_f: torch.Tensor      # (N, k2, 6)
    self_f: torch.Tensor     # (N, 2 + 2h + 2 + 1)


class StepOutputs(NamedTuple):
    """Per-frame recorded outputs (stacked along time by :func:`rollout`)."""

    p: torch.Tensor
    v: torch.Tensor
    a: torch.Tensor
    mask: torch.Tensor              # presence at recording time
    collisions: torch.Tensor        # (N,) soft contact counts (or zeros)
    hard_collisions: torch.Tensor
    coll_pred: torch.Tensor         # (N, k1) per-edge collision predictions
    true_coll: torch.Tensor         # (N, k1) labels recomputed from features
    msg_l1: torch.Tensor            # sum |ped_msgs| (per channel)


class SpawnFrame(NamedTuple):
    """Ground-truth teleport-in data; time-leading in :func:`rollout`."""

    new: torch.Tensor        # (N,) 0/1 — agents appearing at this frame
    p: torch.Tensor
    v: torch.Tensor
    a: torch.Tensor
    dest: torch.Tensor
    dest_idx: torch.Tensor
    hist_v: torch.Tensor


def select_waypoint(waypoints: torch.Tensor,
                    dest_idx: torch.Tensor) -> torch.Tensor:
    """``waypoints[dest_idx[n], n]`` with NaN-padded rows read as 0."""
    n = torch.arange(waypoints.shape[1], device=waypoints.device)
    return torch.nan_to_num(waypoints)[dest_idx.long(), n]


def make_features_fn(cfg: EngineConfig, obstacles: torch.Tensor,
                     desired_speed: torch.Tensor, obstacle_index=None,
                     mesh=None, mesh_axis: str = "ap"):
    """The per-step feature rebuild ``(p, v, a, dest, hist_v, k1, k2) ->
    (ped_f, obs_f, self_f)`` with a single-frame heading, for ``(N, 2)``
    frames or ``(C, N, 2)`` batches of frames (the channel-batched banded
    route of ``relative_features``).

    ``cfg.shard_agents`` shards the pair pass of an ``(N, 2)`` frame over
    ``mesh``'s ``mesh_axis`` (``parallel/agent_shard.py``), with the JAX
    package's gate (piml_tpu/engine/rollout.py:168-172) less its "on a
    TPU" condition, as the single-device route drops it: K2 under
    sharding when ``use_grid_topk`` and N² ≥ 2^21 (on the CPU, its plain
    version), else the ring pass."""
    if cfg.shard_agents and mesh is None:
        raise ValueError("EngineConfig.shard_agents requires a mesh")

    def features_for(p, v, a, dest, hist_v, k1, k2):
        with annotate("frame.features"):
            # k1/k2 keep the neighbour axes at the dataset-seeded widths
            ncfg = cfg.neighbor._replace(topk_ped=k1, topk_obs=k2)
            if cfg.shard_agents:
                from piml_tpu_torch.parallel import agent_shard

                if p.ndim != 2:
                    raise ValueError("shard_agents takes one (N, 2) frame")
                sharded = (agent_shard.sharded_banded_features
                           if ncfg.use_grid_topk and p.shape[0] ** 2 >= _GATE
                           else agent_shard.sharded_relative_features)
                ped_f, obs_f, dest_f = sharded(p, v, a, dest, obstacles, ncfg,
                                               mesh, mesh_axis)
            else:
                v0 = torch.where(torch.isnan(v), 0.0, v)
                ped_f, obs_f, dest_f = relative_features(
                    p, v, a, dest, obstacles, ncfg,
                    heading=heading_direction(v0, time_axis=False),
                    obstacle_index=obstacle_index, batched=p.ndim == 3)
            ds = desired_speed.expand(p.shape[:-1] + desired_speed.shape[-1:])
            self_f = torch.cat([dest_f, hist_v, a, ds], dim=-1)
            return ped_f, obs_f, self_f

    return features_for


def make_step(model: Callable, cfg: EngineConfig, waypoints: torch.Tensor,
              dest_num: torch.Tensor, obstacles: torch.Tensor,
              desired_speed: torch.Tensor, obstacle_index=None, mesh=None,
              mesh_axis: str = "ap"):
    """Build the step ``(state, spawn, seeds=None) -> (state, outputs)``
    for an ``(N, ...)`` state or a ``(C, N, ...)`` batch of window
    channels; ``model`` maps ``(ped_f, obs_f, self_f[, rng])`` to a
    ``ModelOutput``.

    ``seeds`` (one int per channel) makes the step stochastic: the model's
    dropout draws from generators seeded with them (the JAX package's
    per-frame, per-channel dropout keys).  ``mesh``: see
    :func:`make_features_fn`."""
    dt = cfg.time_unit
    features_for = make_features_fn(cfg, obstacles, desired_speed,
                                    obstacle_index=obstacle_index,
                                    mesh=mesh, mesh_axis=mesh_axis)

    def step(state: EngineState, spawn: SpawnFrame,
             seeds: Optional[Sequence[int]] = None):
        with annotate("frame"):
            present = (~torch.isnan(state.p[..., 0])).to(state.p.dtype)

            with annotate("frame.model"):
                if seeds is None:
                    out = model(state.ped_f, state.obs_f, state.self_f)
                else:
                    rng = [torch.Generator(device=state.p.device)
                           .manual_seed(int(s)) for s in seeds]
                    out = model(state.ped_f, state.obs_f, state.self_f, rng)
            a_next = out.pred_acc
            # one sum per frame (per channel for a batched state)
            lead = state.p.ndim - 2
            msg_l1 = (out.ped_msgs.abs().flatten(lead).sum(-1)
                      if out.ped_msgs is not None
                      else torch.zeros(state.p.shape[:lead],
                                       device=state.p.device))

            if cfg.track_collisions:
                # contact counts carry no gradient (simulators.py:708)
                p_sg = state.p.detach()
                with annotate("contacts.frame", device=True):
                    coll = collision_detection_single_frame(
                        p_sg, cfg.collision_threshold)
                with annotate("contacts.frame", device=True):
                    hard = collision_detection_single_frame(
                        p_sg, cfg.collision_threshold / 2)
            else:
                coll = torch.zeros_like(present)
                hard = torch.zeros_like(present)

            if cfg.track_collision_labels and out.coll_pred is not None:
                coll_pred = out.coll_pred
                true_coll = collision_label(state.ped_f)
            else:
                k1 = state.ped_f.shape[-2]
                coll_pred = torch.zeros(state.p.shape[:-1] + (k1,),
                                        dtype=state.p.dtype,
                                        device=state.p.device)
                true_coll = torch.zeros_like(coll_pred)

            if cfg.lagged:
                v_next = state.v + state.a * dt
                p_next = state.p + state.v * dt
            else:
                v_next = state.v + a_next * dt
                p_next = state.p + v_next * dt

            # waypoint advance, retirement
            dis = torch.linalg.vector_norm(state.p - state.dest, dim=-1)
            dest_idx = state.dest_idx + (dis < 0.5).to(state.dest_idx.dtype)
            arrived = dest_idx > dest_num - 1
            if cfg.retire_on_arrival:
                p_next = torch.where(arrived[..., None], torch.nan, p_next)
            dest_idx = torch.where(arrived, dest_idx - 1, dest_idx)
            dest_next = select_waypoint(waypoints, dest_idx)

            hist_v = torch.cat([state.hist_v[..., 2:], v_next], dim=-1)

            # teleport-in of newly appearing agents
            new = spawn.new[..., None] == 1
            p_next = torch.where(new, spawn.p, p_next)
            v_next = torch.where(new, spawn.v, v_next)
            a_next = torch.where(new, spawn.a, a_next)
            dest_next = torch.where(new, spawn.dest, dest_next)
            dest_idx = torch.where(spawn.new == 1, spawn.dest_idx, dest_idx)
            hist_v = torch.where(new, spawn.hist_v, hist_v)

            ped_f, obs_f, self_f = features_for(
                p_next, v_next, a_next, dest_next, hist_v,
                state.ped_f.shape[-2], state.obs_f.shape[-2])

            new_state = EngineState(
                p=p_next, v=v_next, a=a_next, dest=dest_next,
                dest_idx=dest_idx, hist_v=hist_v, ped_f=ped_f, obs_f=obs_f,
                self_f=self_f)
            outputs = StepOutputs(
                p=state.p, v=state.v, a=state.a, mask=present,
                collisions=coll, hard_collisions=hard,
                coll_pred=coll_pred, true_coll=true_coll, msg_l1=msg_l1)
            return new_state, outputs

    return step


def init_state(p, v, a, dest, dest_idx, ped_f, obs_f, self_f) -> EngineState:
    """Seed the state from dataset tensors at ``t_start``; ``self_f[..., 2:-3]``
    holds the history velocities (simulators.py:571-573,624)."""
    return EngineState(
        p=p, v=v, a=a, dest=dest, dest_idx=dest_idx.to(torch.int32),
        hist_v=self_f[..., 2:-3], ped_f=ped_f, obs_f=obs_f, self_f=self_f)


def _obstacle_index(cfg: EngineConfig, state: EngineState,
                    obstacles: torch.Tensor):
    """The obstacle table is static: build the banded selector's index
    once per rollout, with the state-seeded neighbour widths."""
    ncfg_k = cfg.neighbor._replace(topk_ped=state.ped_f.shape[-2],
                                   topk_obs=state.obs_f.shape[-2])
    return prepare_obstacle_index(state.p.shape[-2], obstacles, ncfg_k)


@torch.inference_mode()
def rollout(model: Callable, cfg: EngineConfig, state: EngineState,
            spawns: SpawnFrame, waypoints: torch.Tensor,
            dest_num: torch.Tensor, obstacles: torch.Tensor,
            desired_speed: torch.Tensor, mesh=None, mesh_axis: str = "ap"):
    """Run ``T_roll = spawns.new.shape[0]`` steps from ``state``; returns
    ``(final_state, StepOutputs)`` with time-major outputs.  With
    ``cfg.shard_agents`` the pair pass runs sharded over ``mesh`` (every
    rank passes and gets the whole state), and no obstacle index is
    prebuilt: the sharded passes select obstacles densely."""
    with annotate("rollout"):
        step = make_step(model, cfg, waypoints, dest_num, obstacles,
                         desired_speed,
                         obstacle_index=(None if cfg.shard_agents else
                                         _obstacle_index(cfg, state,
                                                         obstacles)),
                         mesh=mesh, mesh_axis=mesh_axis)
        outs: List[StepOutputs] = []
        for t in range(spawns.new.shape[0]):
            state, o = step(state, SpawnFrame(*(x[t] for x in spawns)))
            outs.append(o)
        return state, StepOutputs(*(torch.stack(x) for x in zip(*outs)))


def batched_rollout(model: Callable, cfg: EngineConfig, state: EngineState,
                    spawns: SpawnFrame, waypoints: torch.Tensor,
                    dest_num: torch.Tensor, obstacles: torch.Tensor,
                    desired_speed: torch.Tensor,
                    step_seeds: Optional[torch.Tensor] = None):
    """Channel-batched rollout for the BPTT finetune: ``state`` is
    ``(C, N, ...)``, ``spawns`` channel-leading ``(C, T, ...)``; returns
    ``(final_state, StepOutputs)`` with channel-leading ``(C, T, ...)``
    outputs, like the JAX package's ``batched_rollout``.

    Each frame runs the step on the whole batch, so the feature pass is one
    batched call per frame (one channel-batched K2 launch per pass on the
    card, one exactness decision for the batch).  Autograd follows the
    caller's mode.  ``cfg.remat`` checkpoints each frame: only the state
    between frames stays alive, and the backward recomputes the frame.
    ``step_seeds`` ``(C, T)``: the frame's dropout seeds, drawn before the
    loop; the frame builds its generators from them inside the
    checkpointed body, so a recomputed frame draws the same masks (the
    checkpoint restores only the global RNG, which dropout never reads).
    """
    remat = cfg.remat and torch.is_grad_enabled()
    with annotate("rollout"):
        step = make_step(model, cfg, waypoints, dest_num, obstacles,
                         desired_speed,
                         obstacle_index=_obstacle_index(cfg, state, obstacles))
        outs: List[StepOutputs] = []
        for t in range(spawns.new.shape[1]):
            spawn = SpawnFrame(*(x[:, t] for x in spawns))
            seeds = None if step_seeds is None else step_seeds[:, t].tolist()
            if remat:
                state, o = checkpoint(step, state, spawn, seeds,
                                      use_reentrant=False,
                                      preserve_rng_state=False)
            else:
                state, o = step(state, spawn, seeds)
            outs.append(o)
        return state, StepOutputs(*(torch.stack(x, dim=1)
                                    for x in zip(*outs)))


def spawn_frames_from_scene(position, velocity, acceleration, destination,
                            dest_idx, self_features, mask_p, mask_p_pred,
                            t_start: int) -> SpawnFrame:
    """The teleport-in schedule from ground truth: ``new = mask_p −
    mask_p_pred`` (simulators.py:593); step ``t`` injects frame ``t+1``,
    so the frames are ``t_start+1 .. T`` with a zero final frame."""
    new_flag = (mask_p - mask_p_pred).to(position.dtype)

    def shift(x):
        return torch.cat([x[t_start + 1:], torch.zeros_like(x[:1])], dim=0)

    def nan0(x):
        return torch.where(torch.isnan(x), 0.0, x)

    return SpawnFrame(
        new=shift(new_flag),
        p=shift(nan0(position)),
        v=shift(velocity),
        a=shift(acceleration),
        dest=shift(nan0(destination)),
        dest_idx=shift(dest_idx).to(torch.int32),
        hist_v=shift(self_features[..., 2:-3]),
    )

"""Agent-axis sharding of the O(N²) pair pass.

Counterpart of ``piml_tpu/parallel/agent_shard.py``.  The query agents
split over the mesh axis; each rank selects the neighbours of its own
``N/D`` agents and the ranks' results are gathered, so every function
here takes the full frame on every rank and returns the full features on
every rank (the JAX functions' global outputs).

- :func:`ring_topk_neighbors`: JAX passes the key tiles around the ring
  (``lax.ppermute``).  The ``(N, 6)`` state table is small and every rank
  holds it already, so a rank reads the key tiles from it in the ring's
  order, ``src = (my − step) mod D``, scoring one ``(N/D, N/D)`` block at a
  time with the JAX package's matmul-expansion distances and merging a
  running top-k by a stable sort (``lax.top_k``'s tie order: the lower
  position first).
- :func:`sharded_relative_features`: the ring pass, and the obstacle pass
  each rank runs on its agents against the whole obstacle table.
- :func:`sharded_banded_features`: K2's multi-chip caller
  (piml_tpu/parallel/agent_shard.py:286).  Every rank cell-sorts the
  whole table and runs K2 on its own agents with ``self_ids``, the
  exactness flags are AND-ed across the ranks, and if any rank's proof
  fails every rank takes the ring pass, so no two ranks part ways before
  the next collective.

Selection and features carry no gradient here: the sharded passes serve
the evaluation rollout (the finetune shards channels, not agents).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from piml_tpu_torch.ops import banded
from piml_tpu_torch.ops.pairwise import cos_threshold
from piml_tpu_torch.parallel import distributed as pd
from piml_tpu_torch.parallel.sharding import axis_group, axis_rank, axis_size
from piml_tpu_torch.physics.features import (INF, NeighborConfig,
                                             heading_direction,
                                             nearby_in_sight)

__all__ = ["ring_topk_neighbors", "sharded_relative_features",
           "sharded_banded_features"]


def _tile_scores(q_pos, q_head, q_absent, q_gidx, key_tile, k_gidx,
                 angle_threshold: float) -> torch.Tensor:
    """FOV-masked distances from the local queries to one key tile,
    ``(M, Mt)``: the semantics of ``nearby_in_sight`` (self pair pinned to
    distance 0 / cos 0, absent rows at +inf, the literal
    ``cos(3.14·θ/180)`` threshold) with the JAX package's matmul-expansion
    distances (piml_tpu/parallel/agent_shard.py:37-71)."""
    k_pos = key_tile[:, :2]
    k_absent = torch.isnan(k_pos).any(dim=-1)
    k_pos = torch.where(torch.isnan(k_pos), 0.0, k_pos)

    d2 = ((q_pos * q_pos).sum(dim=-1)[:, None]
          + (k_pos * k_pos).sum(dim=-1)[None, :]
          - 2.0 * (q_pos @ k_pos.T))
    dist = torch.sqrt(torch.clamp_min(d2, 0.0))
    invalid = q_absent[:, None] | k_absent[None, :]
    dist = torch.where(invalid, INF, dist)

    rel_dot_h = (q_head @ k_pos.T
                 - (q_pos * q_head).sum(dim=-1)[:, None])
    h_norm = torch.clamp_min(torch.linalg.vector_norm(q_head, dim=-1), 1e-8)
    cos = rel_dot_h / torch.clamp_min(dist, 1e-8) / h_norm[:, None]
    cos = torch.where(invalid | torch.isnan(cos), -1.0, cos)

    self_pair = (q_gidx[:, None] == k_gidx[None, :]) & ~invalid
    dist = torch.where(self_pair, 0.0, dist)
    cos = torch.where(self_pair, 0.0, cos)
    return torch.where(cos < cos_threshold(angle_threshold), INF, dist)


def _check_divides(n: int, n_dev: int, axis: str) -> int:
    if n % n_dev:
        raise ValueError(f"N={n} must divide the {axis} axis ({n_dev}): pad "
                         "the agents (data.views.pad_agents)")
    return n // n_dev


@torch.no_grad()
def _ring_local(state: torch.Tensor, heading: torch.Tensor, k: int,
                angle_threshold: float, mesh: DeviceMesh, axis: str
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's ``(dist (N/D, k), rows (N/D, k, 6))`` of the ring pass."""
    n_dev, my = axis_size(mesh, axis), axis_rank(mesh, axis)
    m = _check_divides(state.shape[0], n_dev, axis)
    dev = state.device
    tile = state[my * m:(my + 1) * m]
    head = heading[my * m:(my + 1) * m]
    q_absent = torch.isnan(tile[:, :2]).any(dim=-1)
    q_pos = torch.where(torch.isnan(tile[:, :2]), 0.0, tile[:, :2])
    q_gidx = my * m + torch.arange(m, device=dev)
    run_d = torch.full((m, k), INF, dtype=state.dtype, device=dev)
    run_rows = torch.zeros((m, k, state.shape[-1]), dtype=state.dtype,
                           device=dev)
    k_tile = min(k, m)
    for step in range(n_dev):
        src = (my - step) % n_dev       # whose tile the ring holds now
        key = state[src * m:(src + 1) * m]
        dist = _tile_scores(q_pos, head, q_absent, q_gidx, key,
                            src * m + torch.arange(m, device=dev),
                            angle_threshold)
        d_new, idx = torch.sort(dist, dim=-1, stable=True)
        rows = key[idx[:, :k_tile]]
        rows = torch.where(torch.isnan(rows), 0.0, rows)
        all_d = torch.cat([run_d, d_new[:, :k_tile]], dim=-1)
        all_rows = torch.cat([run_rows, rows], dim=-2)
        run_d, sel = torch.sort(all_d, dim=-1, stable=True)
        run_d = run_d[:, :k]
        sel = sel[:, :k, None].expand(-1, -1, all_rows.shape[-1])
        run_rows = torch.gather(all_rows, 1, sel)
    return run_d, run_rows


def ring_topk_neighbors(state: torch.Tensor, heading: torch.Tensor, k: int,
                        angle_threshold: float, mesh: DeviceMesh,
                        axis: str = "ap"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k in-FOV neighbour selection with the query agents sharded.

    ``state`` ``(N, 6)`` = ``[p, v, a]`` rows (NaN position = absent),
    ``heading`` ``(N, 2)``, the same on every rank; N must divide the mesh
    axis.  Returns ``(dist (N, k), rows (N, k, 6))``, the selected
    neighbours' state rows (NaN → 0), on every rank."""
    group = axis_group(mesh, axis)
    d, rows = _ring_local(state, heading, k, angle_threshold, mesh, axis)
    return pd.all_gather(d, group), pd.all_gather(rows, group)


def _frame_state(position, velocity, acceleration):
    velocity = torch.where(torch.isnan(velocity), 0.0, velocity)
    acceleration = torch.where(torch.isnan(acceleration), 0.0, acceleration)
    heading = heading_direction(velocity, time_axis=False)
    return torch.cat([position, velocity, acceleration], dim=-1), heading


@torch.no_grad()
def _obstacle_pass(state_tile, head_tile, obstacles, cfg: NeighborConfig):
    """One rank's obstacle features against the whole (small) table."""
    k2 = min(cfg.topk_obs, obstacles.shape[0])
    od, oi = nearby_in_sight(state_tile[:, :2], obstacles, head_tile, k2,
                             cfg.sight_angle_obs)
    zeros = torch.zeros_like(obstacles)
    obs_state = torch.cat([obstacles, zeros, zeros], dim=-1)
    rel_o = obs_state[oi] - state_tile[:, None, :]
    keep_o = (od <= cfg.dist_threshold_obs)[..., None]
    return torch.where(keep_o & torch.isfinite(rel_o), rel_o, 0.0)


def _dest(destination, position):
    rel = destination - position
    return torch.where(torch.isnan(rel), 0.0, rel)


@torch.no_grad()
def sharded_relative_features(
    position: torch.Tensor,
    velocity: torch.Tensor,
    acceleration: torch.Tensor,
    destination: torch.Tensor,
    obstacles: torch.Tensor,
    cfg: NeighborConfig,
    mesh: DeviceMesh,
    axis: str = "ap",
    include_obstacles: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """One frame's relative features with the agent axis sharded: the
    output of ``physics.features.relative_features`` on that frame.

    Inputs ``(N, 2)`` NaN-masked and ``obstacles (M, 2)``, the same on
    every rank.  Returns ``(ped (N, k1, 6), obs (N, k2, 6), dest (N, 2))``
    on every rank; ``include_obstacles=False`` skips the obstacle pass
    (``obs`` is None: the banded caller's fallback has its own)."""
    group = axis_group(mesh, axis)
    n_dev, my = axis_size(mesh, axis), axis_rank(mesh, axis)
    state, heading = _frame_state(position, velocity, acceleration)
    m = _check_divides(state.shape[0], n_dev, axis)
    tile = slice(my * m, (my + 1) * m)

    k1 = min(cfg.topk_ped, state.shape[0])
    dist, rows = _ring_local(state, heading, k1, cfg.sight_angle_ped, mesh,
                             axis)
    state_t = state[tile]
    rel = rows - torch.where(torch.isnan(state_t), 0.0, state_t)[:, None, :]
    keep = (dist <= cfg.dist_threshold_ped)[..., None]
    ped = pd.all_gather(torch.where(keep & torch.isfinite(rel), rel, 0.0),
                        group)
    obs = None
    if include_obstacles:
        obs = pd.all_gather(
            _obstacle_pass(state_t, heading[tile], obstacles, cfg), group)
    return ped, obs, _dest(destination, position)


@torch.no_grad()
def sharded_banded_features(
    position: torch.Tensor,
    velocity: torch.Tensor,
    acceleration: torch.Tensor,
    destination: torch.Tensor,
    obstacles: torch.Tensor,
    cfg: NeighborConfig,
    mesh: DeviceMesh,
    axis: str = "ap",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The O(N) multi-rank feature pass: K2 under agent-axis sharding.

    The ring pass scores every query against every tile (O(N²/D) a rank).
    Here every rank cell-sorts the whole state table (JAX all-gathers it;
    here every rank holds it already) and runs K2 on its own ``N/D``
    agents against it, with ``self_ids`` = their global indices, so its
    work is O(N/D · window).  Each rank proves exactness for its own
    agents; the proofs are AND-ed by an all-reduce, and when any fails,
    every rank takes the ring pass for the agent features
    (``banded.KERNEL.fallbacks``).  The obstacle pass is each rank's dense
    pass against the whole table, as in the ring pass.  Exact results are
    the single-device dense pass's (K2 breaks ties by the lowest global
    id).  ``banded.KERNEL.sharded_calls`` counts the calls.  Same contract
    as :func:`sharded_relative_features`."""
    group = axis_group(mesh, axis)
    n_dev, my = axis_size(mesh, axis), axis_rank(mesh, axis)
    n = position.shape[0]
    m_loc = _check_divides(n, n_dev, axis)
    tile = slice(my * m_loc, (my + 1) * m_loc)
    state, heading = _frame_state(position, velocity, acceleration)
    banded.KERNEL.sharded_calls += 1

    k1 = min(cfg.topk_ped, n)
    # m_loc queries a rank against the whole table: a tile of sorted local
    # queries spans ~D× more cells than on one device, which
    # auto_window's query count accounts for
    g_p, w_p = banded.banded_params(m_loc, n, k1, fine=True)
    index = banded.build_object_index(position, g_p, w_p)
    self_ids = my * m_loc + torch.arange(m_loc, device=position.device)
    state_t = state[tile]
    dist, idx, exact = banded.topk_neighbors_banded(
        position[tile], heading[tile], k1, cfg.sight_angle_ped,
        objects=position, same_objects=False, grid_dim=g_p, window=w_p,
        dist_threshold=cfg.dist_threshold_ped, index=index,
        self_ids=self_ids)
    rel = state[idx] - state_t[:, None, :]
    keep = (dist <= cfg.dist_threshold_ped)[..., None]
    ped_t = torch.where(keep & torch.isfinite(rel), rel, 0.0)
    obs = pd.all_gather(
        _obstacle_pass(state_t, heading[tile], obstacles, cfg), group)

    exact_all = int(pd.all_reduce(exact.to(torch.int32)[None], group)) == n_dev
    if exact_all:
        ped = pd.all_gather(ped_t, group)
    else:
        banded.KERNEL.fallbacks += 1
        ped, _, _ = sharded_relative_features(
            position, velocity, acceleration, destination, obstacles, cfg,
            mesh, axis, include_obstacles=False)
    return ped, obs, _dest(destination, position)

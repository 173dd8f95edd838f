"""Plain PyTorch reference of the social-force generator the paper pretrains
on: the classic Helbing model with the knobs of the reference's
``src/configs/socialforce.yaml:72-80`` (github.com/tsinghua-fib-lab/PIML).

Written from the model's description; it imports nothing of the measured
program.  Pedestrian ``i`` at ``p_i`` with velocity ``v_i``, desired speed
``s_i`` and goal direction ``e_i`` (towards its current waypoint) feels

    F_i = k (s_i e_i − v_i)
          − Σ_j [j in sight of i] A_p exp(−r_ij / B_p) r̂_ij
          − Σ_m A_o exp(−r_im / B_o) r̂_im

where ``r̂_ij`` is the unit vector from ``p_i`` towards ``p_j`` (``r_ij``
its length), ``m`` runs over the obstacle points, and ``j`` is in sight
when the angle between ``i``'s walking direction and ``r̂_ij`` is at most
the sight angle.  Walls act from all sides.  A frame is ``oversampling``
Euler sub-steps of ``time_unit / oversampling``: ``v' = v + F dt``, the
speed capped at ``max_speed_multiplier · s_i``, then ``p' = p + v' dt``.
After its sub-steps a pedestrian within ``arrive_distance`` of its waypoint
moves on to the next, and one past its last waypoint leaves the scene.

Departures from the description, each the generator's own rule:

- slots are fixed: slot ``n`` enters at frame ``spawn_frame[n]``; an
  absent slot (not yet entered, or gone) has a NaN position, feels no
  force and exerts none; a frame's sub-steps move only the slots present
  at its start;
- the walking direction is the velocity, or the goal direction where the
  velocity is 0 (a pedestrian just entered);
- lengths are floored: 1e-8 m for the goal direction, 1e-6 m for the
  pair distances, and a pair at distance 0 (the self pair) exerts
  nothing.

Each term is taken in float32 in the generator's order of operations
(``−A exp(−r/B) · d`` and then ``/ r``, the sums over ``j`` and ``m`` of
the same ``(N, N, 2)`` and ``(N, M, 2)`` tensors), so a sound program meets
the reference bit for bit on one device; a program that takes the same
terms in another order moves a pedestrian across the sight cone's edge
now and then, and reads millimetres on ``pos_gap_max_m``.

``pair_dtype`` bfloat16 gives the benchmark's control: the differences
``p_j − p_i`` and ``m − p_i`` are taken in float32 and every pair term
after them in bfloat16, the sums over ``j`` and ``m`` in float32.  The law
has no matrix product, so TF32 cannot be its lower precision.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Knobs(NamedTuple):
    """The model's constants (the sight angle in degrees)."""

    intensity: float        # goal force, 1/s
    ped_A: float            # pedestrian repulsion, m/s²
    ped_B: float            # its range, m
    obs_A: float            # obstacle repulsion, m/s²
    obs_B: float            # its range, m
    oversampling: int       # sub-steps a frame
    speed_cap: float        # the speed cap over the desired speed
    sight_deg: float
    time_unit: float        # s a frame
    arrive: float           # waypoint radius, m


def fp32_only() -> None:
    """No TF32 anywhere: the reference is float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _length(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _repulsion(d: torch.Tensor, A: float, B: float) -> torch.Tensor:
    """``−A exp(−r/B) d/r`` for each difference ``d`` (…, 2), ``r`` its
    length floored at 1e-6 m."""
    r = torch.clamp_min(_length(d), 1e-6)
    return -(A * torch.exp(-r / B)) * d / r


def force(k: Knobs, p, v, dest, speed, obstacles,
          pair_dtype=torch.float32) -> torch.Tensor:
    """The force on every slot ``(N, 2)`` (NaN on absent slots, which the
    integration leaves out)."""
    here = torch.isfinite(p[:, 0])
    to_goal = dest - p
    e = to_goal / torch.clamp_min(_length(to_goal), 1e-8)
    goal = k.intensity * (speed[:, None] * e - v)

    walk = torch.where(_length(v) > 0, v, e)
    d = p[None, :, :] - p[:, None, :]                       # i, j: p_j − p_i
    pair = here[:, None] & here[None, :]
    d = torch.where(pair[..., None], d, 0.0).to(pair_dtype)
    w = walk.to(pair_dtype)[:, None, :]
    r = _length(d)[..., 0]
    cos = (d * w).sum(-1) / (torch.clamp_min(r, 1e-6)
                             * torch.clamp_min(_length(w)[..., 0], 1e-8))
    sight = cos >= math.cos(math.radians(k.sight_deg))
    ped = torch.where((pair & (r > 0) & sight)[..., None],
                      _repulsion(d, k.ped_A, k.ped_B), 0.0)

    do = obstacles[None, :, :] - p[:, None, :]              # i, m: o_m − p_i
    do = torch.where(here[:, None, None], do, 0.0).to(pair_dtype)
    obs = _repulsion(do, k.obs_A, k.obs_B)
    return goal + ped.float().sum(1) + obs.float().sum(1)


class Run(NamedTuple):
    p: torch.Tensor        # (T, N, 2), NaN where absent
    v: torch.Tensor        # (T, N, 2)
    active: torch.Tensor   # (T, N) 0/1


@torch.no_grad()
def generate(k: Knobs, spawn_frame, position, velocity, waypoints, dest_num,
             desired_speed, obstacles, frames: int,
             pair_dtype=torch.float32) -> Run:
    """``frames`` frames of the generator over fixed slots: slot ``n``
    enters at frame ``spawn_frame[n]`` at ``position[n]`` with
    ``velocity[n]``, walks to ``waypoints[:dest_num[n], n]`` in turn and
    leaves past the last.  Records each frame's state after its
    sub-steps."""
    n = position.shape[0]
    dev = position.device
    wp = torch.nan_to_num(waypoints)
    ids = torch.arange(n, device=dev)
    dt = k.time_unit / k.oversampling
    cap = k.speed_cap * desired_speed[:, None]
    p = torch.full((n, 2), math.nan, device=dev)
    v = torch.zeros((n, 2), device=dev)
    idx = torch.zeros(n, dtype=torch.long, device=dev)
    active = torch.zeros(n, dtype=torch.bool, device=dev)
    last = dest_num.long() - 1
    ps, vs, acts = [], [], []
    for t in range(frames):
        new = spawn_frame == t
        active = active | new
        p = torch.where(new[:, None], position, p)
        v = torch.where(new[:, None], velocity, v)
        idx = torch.where(new, 0, idx)
        dest = wp[torch.clamp(idx, 0, wp.shape[0] - 1), ids]
        moving = active[:, None]
        for _ in range(k.oversampling):
            f = force(k, p, v, dest, desired_speed, obstacles, pair_dtype)
            v_new = v + f * dt
            s = _length(v_new)
            v_new = torch.where(s > cap,
                                v_new / torch.clamp_min(s, 1e-8) * cap, v_new)
            p = torch.where(moving, p + v_new * dt, p)
            v = torch.where(moving, v_new, v)
        near = _length(p - dest)[:, 0] < k.arrive
        idx = idx + (near & active).long()
        done = idx > last
        idx = torch.where(done, last, idx)
        active = active & ~done
        p = torch.where(active[:, None], p, math.nan)
        ps.append(p)
        vs.append(v)
        acts.append(active.float())
    return Run(torch.stack(ps), torch.stack(vs), torch.stack(acts))

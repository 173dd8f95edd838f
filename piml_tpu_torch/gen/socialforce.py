"""The social-force synthetic-data generator.

Counterpart of ``piml_tpu/gen/socialforce.py``: the component the
reference uses but never shipped (``models.socialforce.simulator``,
imported by src/data/scenarios.py:34 and configured by
src/configs/socialforce.yaml:72-80).  A scenario pre-samples its whole
Poisson arrival schedule into fixed-capacity ``(N_cap,)`` spawn arrays, and
the simulation steps every slot, inactive ones NaN and masked, so no shape
depends on the data.  The JAX package runs the frames as one ``lax.scan``;
here they are a Python loop of ``oversampling`` sub-steps a frame, every
step on the schedule's device with no host read inside the loop.  The
physics is the classic Helbing model with the reference's config knobs:

- goal force ``intensity · (v0·ê − v)`` (``desired_speed_intensity``; the
  reference's ``SocialForceData.default_tau = 0.5`` corresponds to
  intensity 2.0),
- ped-ped repulsion ``A·exp(−r/B)`` inside the sight cone
  (``pedped_repulsive_intensity/radius``, ``sight_angle_ped``),
- ped-obstacle repulsion ``A·exp(−r/B)`` (``pedobs_repulsive_*``),
- ``oversampling`` integration sub-steps per recorded frame,
- speed clamp at ``max_speed_multiplier · v0``.

Under a profiler each frame of :func:`simulate` is a ``frame`` span and its
sub-steps an ``sf.substeps`` device span inside it; :data:`PAIRS` counts the
pairs :func:`social_force` evaluates.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from piml_tpu_torch.engine.rollout import select_waypoint
from piml_tpu_torch.scene import Scene
from piml_tpu_torch.utils.profiling import annotate

Device = Union[str, torch.device]


@dataclasses.dataclass(frozen=True)
class SFParams:
    """Knobs named after src/configs/socialforce.yaml."""

    desired_speed_intensity: float = 2.0
    pedped_repulsive_intensity: float = 3.3
    pedped_repulsive_radius: float = 0.4
    pedobs_repulsive_intensity: float = 10.0
    pedobs_repulsive_radius: float = 0.2
    oversampling: int = 10
    max_speed_multiplier: float = 1.4
    sight_angle_ped: float = 90.0
    time_unit: float = 0.08
    arrive_distance: float = 1.0  # waypoint-advance radius (scenarios.py:68)


class SpawnSchedule(NamedTuple):
    """Pre-sampled arrivals for ``T`` frames over ``N_cap`` slots."""

    spawn_frame: torch.Tensor     # (N_cap,) int32 activation frame, T = never
    position: torch.Tensor        # (N_cap, 2)
    velocity: torch.Tensor        # (N_cap, 2)
    waypoints: torch.Tensor       # (D, N_cap, 2) NaN-padded
    dest_num: torch.Tensor        # (N_cap,)
    desired_speed: torch.Tensor   # (N_cap,)

    def to(self, device: Device) -> "SpawnSchedule":
        return SpawnSchedule(*(x.to(device) for x in self))


@dataclasses.dataclass
class PairCount:
    """Pairs :func:`social_force` has evaluated: ``N²`` pedestrian pairs
    (the self pair and absent slots included) and ``N·M`` obstacle pairs
    a call.  Host integers taken from the shapes, so counting reads
    nothing from the card."""

    ped: int = 0
    obs: int = 0


PAIRS = PairCount()


class GenState(NamedTuple):
    p: torch.Tensor          # (N, 2) NaN when inactive
    v: torch.Tensor
    dest_idx: torch.Tensor   # (N,) int32
    active: torch.Tensor     # (N,) 0/1


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def social_force(
    params: SFParams,
    p: torch.Tensor,
    v: torch.Tensor,
    dest: torch.Tensor,
    desired_speed: torch.Tensor,
    obstacles: torch.Tensor,
) -> torch.Tensor:
    """Total force on each agent; NaN-safe (inactive slots give 0 to the
    others).  The ``(N, M, 2)`` obstacle temporaries live only inside this
    call.  Counted in :data:`PAIRS`."""
    PAIRS.ped += p.shape[0] ** 2
    PAIRS.obs += p.shape[0] * obstacles.shape[0]
    ed_raw = dest - p
    ed = ed_raw / torch.clamp_min(_norm(ed_raw), 1e-8)
    goal = params.desired_speed_intensity * (desired_speed[:, None] * ed - v)

    # ped-ped repulsion inside the sight cone
    rel = p[None, :, :] - p[:, None, :]   # i→j
    finite = torch.isfinite(rel).all(dim=-1, keepdim=True)
    rel_s = torch.where(finite, rel, 1.0)
    r = _norm(rel_s)
    r_safe = torch.clamp_min(r, 1e-6)
    heading = torch.where(_norm(v) > 0, v, ed)
    cos = torch.sum(rel_s * heading[:, None, :], dim=-1, keepdim=True) / (
        r_safe * torch.clamp_min(_norm(heading), 1e-8)[:, None])
    in_sight = cos >= math.cos(math.pi * params.sight_angle_ped / 180.0)
    mag = params.pedped_repulsive_intensity * torch.exp(
        -r_safe / params.pedped_repulsive_radius)
    pair = -mag * rel_s / r_safe  # repulsion pushes i away from j
    pair = torch.where(finite & (r > 0) & in_sight, pair, 0.0)
    rep_ped = torch.sum(pair, dim=1)

    # ped-obstacle repulsion (no sight gating — walls act from all sides)
    relo = obstacles[None, :, :] - p[:, None, :]
    finite_o = torch.isfinite(relo).all(dim=-1, keepdim=True)
    relo_s = torch.where(finite_o, relo, 1.0)
    ro = torch.clamp_min(_norm(relo_s), 1e-6)
    mago = params.pedobs_repulsive_intensity * torch.exp(
        -ro / params.pedobs_repulsive_radius)
    pairo = torch.where(finite_o, -mago * relo_s / ro, 0.0)
    rep_obs = torch.sum(pairo, dim=1)

    return goal + rep_ped + rep_obs


def _obstacle_table(obstacles, device: Device) -> torch.Tensor:
    if torch.is_tensor(obstacles):
        return obstacles.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(obstacles, np.float32), device=device)


@torch.no_grad()
def simulate(
    params: SFParams,
    schedule: SpawnSchedule,
    obstacles,
    num_frames: int,
    retire_fn: Optional[Callable] = None,
    advance_fn: Optional[Callable] = None,
    device: Device = "cuda:0",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the generator on ``device``; returns (position (T, N, 2)
    NaN-masked, velocity, active mask (T, N)).

    ``retire_fn(p, dest_idx, dest_num, waypoints) -> (N,) bool`` marks
    agents leaving the scene (defaults to final-waypoint arrival);
    ``advance_fn(p, dest) -> (N,) bool`` triggers waypoint advance
    (defaults to ``|p−dest| < arrive_distance``).
    """
    sched = schedule.to(device)
    obstacles = _obstacle_table(obstacles, device)
    n_cap = sched.position.shape[0]
    n_wp = sched.waypoints.shape[0]
    dt = params.time_unit / params.oversampling
    cap = params.max_speed_multiplier * sched.desired_speed[:, None]

    p = torch.full((n_cap, 2), math.nan, device=device)
    v = torch.zeros((n_cap, 2), device=device)
    dest_idx = torch.zeros(n_cap, dtype=torch.int32, device=device)
    active = torch.zeros(n_cap, device=device)
    ps = torch.empty((num_frames, n_cap, 2), device=device)
    vs = torch.empty_like(ps)
    actives = torch.empty((num_frames, n_cap), device=device)
    for t in range(num_frames):
        with annotate("frame"):
            # spawn slots whose frame has come (a device compare, no host read)
            spawn_now = sched.spawn_frame == t
            active = torch.maximum(active, spawn_now.to(active.dtype))
            p = torch.where(spawn_now[:, None], sched.position, p)
            v = torch.where(spawn_now[:, None], sched.velocity, v)
            dest_idx = torch.where(spawn_now, 0, dest_idx)
            dest = select_waypoint(sched.waypoints,
                                   torch.clamp(dest_idx, 0, n_wp - 1))

            keep = (active == 1)[:, None]
            with annotate("sf.substeps", device=True):
                for _ in range(params.oversampling):
                    f = social_force(params, p, v, dest,
                                     sched.desired_speed, obstacles)
                    v2 = v + f * dt
                    speed = _norm(v2)
                    v2 = torch.where(
                        speed > cap, v2 / torch.clamp_min(speed, 1e-8) * cap,
                        v2)
                    p2 = p + v2 * dt
                    p, v = torch.where(keep, p2, p), torch.where(keep, v2, v)

            # waypoint advance + retirement
            if advance_fn is None:
                adv = _norm(p - dest)[:, 0] < params.arrive_distance
            else:
                adv = advance_fn(p, dest)
            adv = adv & (active == 1)
            dest_idx = dest_idx + adv.to(dest_idx.dtype)
            done = dest_idx > sched.dest_num - 1
            if retire_fn is not None:
                done = done | retire_fn(p, dest_idx, sched.dest_num,
                                        sched.waypoints)
            dest_idx = torch.where(done, sched.dest_num - 1, dest_idx)
            active = torch.where(done, 0.0, active)
            p = torch.where((active == 1)[:, None], p, math.nan)
            ps[t], vs[t], actives[t] = p, v, active
    return ps, vs, actives


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def to_scene(
    params: SFParams,
    schedule: SpawnSchedule,
    obstacles_out,
    ps,
    actives,
    meta: Optional[dict] = None,
    device: Device = "cuda:0",
) -> Scene:
    """Package a generator run as a :class:`Scene` (v2.2-compatible) on
    ``device``.

    Velocity/acceleration are re-derived by the same forward differences the
    codec uses, so a save/load round trip is exact.  Host-side numpy, as in
    the JAX package.
    """
    ps = _host(ps)
    actives = _host(actives)
    T, N, _ = ps.shape
    # keep only slots that ever activated
    used = actives.sum(0) > 1  # ≥2 frames so velocity exists
    ps = ps[:, used]
    actives = actives[:, used]
    wps = _host(schedule.waypoints)[:, used]
    dn = _host(schedule.dest_num)[used]
    N = ps.shape[1]

    dt = params.time_unit
    mask_p = (actives > 0).astype(np.float32)
    mask_v = mask_p.copy()
    mask_a = mask_p.copy()
    for n in range(N):
        frames = np.nonzero(mask_p[:, n])[0]
        if frames.size:
            mask_v[frames[-1], n] = 0
            mask_a[frames[-1], n] = 0
            if frames.size >= 2:
                mask_a[frames[-2], n] = 0

    vel = (np.concatenate([ps[1:], ps[-1:]], 0) - ps) / dt
    vel[mask_v == 0] = 0
    vel = np.nan_to_num(vel)
    acc = (np.concatenate([vel[1:], vel[-1:]], 0) - vel) / dt
    acc[mask_a == 0] = 0
    acc = np.nan_to_num(acc)

    # dense destination track from dest_idx reconstruction: first active
    # waypoint per frame — approximate with waypoint 0 until arrival radius
    dest = np.full_like(ps, np.nan)
    dest_idx = np.zeros((T, N), np.int64)
    cur = np.zeros(N, np.int64)
    for t in range(T):
        present = mask_p[t] > 0
        d = wps[np.clip(cur, 0, wps.shape[0] - 1), np.arange(N)]
        adv = present & (np.linalg.norm(np.nan_to_num(ps[t]) - d, axis=-1)
                         < params.arrive_distance)
        cur = np.minimum(cur + adv, dn - 1)
        dest[t][present] = wps[cur[present], np.nonzero(present)[0]]
        dest_idx[t] = cur

    meta = dict(meta or {})
    meta.setdefault("time_unit", params.time_unit)
    meta.setdefault("source", "piml_tpu_torch.gen.socialforce")
    meta["version"] = "v2.2"
    return Scene.from_arrays(dict(
        meta_data=meta, position=ps.astype(np.float32),
        velocity=vel.astype(np.float32), acceleration=acc.astype(np.float32),
        destination=dest.astype(np.float32), waypoints=wps.astype(np.float32),
        dest_idx=dest_idx, dest_num=dn,
        obstacles=_host(obstacles_out).astype(np.float32).reshape(-1, 2),
        mask_p=mask_p, mask_v=mask_v, mask_a=mask_a,
    ), device=device)

"""Closed-loop simulation with the discovered MLAPM force model.

Counterpart of ``piml_tpu/gen/mlapm_sim.py`` (reference: src/main_mlapm.py
— 7 agents on a circle swapping positions under MLAPM-GC, with per-step
arrival masking).  The loop runs over masked fixed-capacity state, every
step on the device with no host read inside the loop, and the same code
regenerates synthetic scenario ``.npy`` files (the reference's
"simulation" datasets in data/synthetic_data/) by pairing MLAPM with a
scenario spawn schedule.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from piml_tpu_torch.engine.rollout import select_waypoint
from piml_tpu_torch.gen.socialforce import (Device, SFParams, SpawnSchedule,
                                            to_scene)
from piml_tpu_torch.models.mlapm import MLAPMParams, mlapm_step
from piml_tpu_torch.scene import Scene
from piml_tpu_torch.utils.profiling import annotate


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1)


@torch.no_grad()
def circle_demo(n: int = 7, num_frames: int = 200, dt: float = 0.08,
                radius: float = 0.3, seed: int = 0,
                params: Optional[MLAPMParams] = None,
                v0: Optional[torch.Tensor] = None,
                device: Device = "cuda:0"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference demo (main_mlapm.py:5-36): agents on a circle of
    radius 10 walk to their antipodes.  Returns (positions (T, N, 2)
    NaN-masked, alive mask (T, N)).

    The initial velocities are ``v0`` when given, else uniform in [0, 1)
    from ``torch.Generator().manual_seed(seed)`` on the CPU (the JAX
    package draws them with ``jax.random.uniform``, a stream no torch
    generator reproduces)."""
    params = params or MLAPMParams.gc_paper()
    theta = torch.linspace(0, 2 * math.pi * (1 - 1.0 / n), n, device=device)
    p0 = torch.stack([10 * torch.cos(theta), 10 * torch.sin(theta)], dim=-1)
    if v0 is None:
        v0 = torch.rand((n, 2), generator=torch.Generator().manual_seed(seed))
    v = torch.as_tensor(v0, dtype=torch.float32).to(device)
    ds = torch.full((n, 1), 1.5, device=device)
    dest = -p0

    p, alive = p0, torch.ones(n, device=device)
    ps = torch.empty((num_frames, n, 2), device=device)
    alives = torch.empty((num_frames, n), device=device)
    for t in range(num_frames):
        v2 = mlapm_step(params, p, v, ds, dest, dt, radius)
        p2 = p + v2 * dt
        keep = alive[:, None] == 1
        p2 = torch.where(keep, p2, p)
        v2 = torch.where(keep, v2, v)
        arrived = _norm(torch.where(torch.isnan(p2), 0.0, p2) - dest) < radius
        alive = torch.where(arrived, 0.0, alive)
        p = torch.where(alive[:, None] == 1, p2, math.nan)
        v = v2
        ps[t], alives[t] = p, alive
    return ps, alives


@torch.no_grad()
def simulate_mlapm(
    params: MLAPMParams,
    schedule: SpawnSchedule,
    num_frames: int,
    dt: float = 0.08,
    radius: float = 0.3,
    arrive_distance: float = 1.0,
    device: Device = "cuda:0",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run MLAPM over a scenario spawn schedule (masked fixed slots) on
    ``device``; returns (position (T, N, 2) NaN-masked, velocity, active
    mask (T, N)).

    Integration is the MLAPM convention ``v' = v + F·dt; p' = p + v'·dt``
    (main_mlapm.py:26), not the lagged NN-rollout Euler.  Under a
    profiler each frame is a ``frame`` span, its force law an
    ``mlapm.force`` span inside it.
    """
    sched = schedule.to(device)
    n_cap = sched.position.shape[0]
    n_wp = sched.waypoints.shape[0]
    ds = sched.desired_speed[:, None]

    p = torch.full((n_cap, 2), math.nan, device=device)
    v = torch.zeros((n_cap, 2), device=device)
    dest_idx = torch.zeros(n_cap, dtype=torch.int32, device=device)
    active = torch.zeros(n_cap, device=device)
    ps = torch.empty((num_frames, n_cap, 2), device=device)
    vs = torch.empty_like(ps)
    actives = torch.empty((num_frames, n_cap), device=device)
    for t in range(num_frames):
        with annotate("frame"):
            spawn_now = sched.spawn_frame == t
            active = torch.maximum(active, spawn_now.to(active.dtype))
            p = torch.where(spawn_now[:, None], sched.position, p)
            v = torch.where(spawn_now[:, None], sched.velocity, v)
            dest_idx = torch.where(spawn_now, 0, dest_idx)

            dest = select_waypoint(sched.waypoints,
                                   torch.clamp(dest_idx, 0, n_wp - 1))
            v2 = mlapm_step(params, p, v, ds, dest, dt, radius)
            p2 = p + v2 * dt
            keep = (active == 1)[:, None]
            p2 = torch.where(keep, p2, p)
            v2 = torch.where(keep, v2, 0.0)

            adv = ((_norm(torch.where(torch.isnan(p2), 1e4, p2) - dest)
                    < arrive_distance) & (active == 1))
            dest_idx = dest_idx + adv.to(dest_idx.dtype)
            done = dest_idx > sched.dest_num - 1
            dest_idx = torch.where(done, sched.dest_num - 1, dest_idx)
            active = torch.where(done, 0.0, active)
            p = torch.where((active == 1)[:, None], p2, math.nan)
            v = v2
            ps[t], vs[t], actives[t] = p, v, active
    return ps, vs, actives


def regenerate_scenario_npy(
    scenario_name: str, num_frames: int, out_path: str,
    mlapm_params: Optional[MLAPMParams] = None, seed: int = 0,
    time_unit: float = 0.08, device: Device = "cuda:0",
) -> Scene:
    """Regenerate a synthetic scenario with MLAPM on ``device`` and write a
    v2.2 ``.npy`` (the reference's ``*_simulation.npy`` datasets)."""
    from piml_tpu_torch.gen.scenarios import SCENARIOS

    sched, obstacles = SCENARIOS[scenario_name](num_frames, seed=seed,
                                                device=device)
    params = mlapm_params or MLAPMParams.gc_paper()
    ps, _, actives = simulate_mlapm(params, sched, num_frames, dt=time_unit,
                                    device=device)
    scene = to_scene(SFParams(time_unit=time_unit), sched, obstacles, ps,
                     actives,
                     meta={"source": f"piml_tpu_torch mlapm {scenario_name}"},
                     device=device)
    if out_path:
        scene.save(out_path)
    return scene

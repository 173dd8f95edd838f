"""Procedural scenario library (reference: src/data/scenarios.py).

Counterpart of ``piml_tpu/gen/scenarios.py``, whose host-side numpy
sampling is copied line for line, so a seed gives the JAX package's
schedules bit for bit.  Each scenario pre-samples its full Poisson arrival
stream into a fixed-capacity
:class:`~piml_tpu_torch.gen.socialforce.SpawnSchedule` of tensors on
``device``, replacing the reference's per-frame ``update(frame)`` closures
+ dynamic tensor growth.  The sampled distributions match the reference:

- ``crosswalk`` (scenarios.py:9-85): bidirectional crossing, v0 ~
  N(1.34, 0.26), Poisson(5/s) arrivals, two waypoints (exit + turn).
- ``four_directional_square`` (scenarios.py:87-134): 4-way grid exchange with
  a circular obstacle (R=5), no arrivals.
- ``basic_unit1/2/3`` (scenarios.py:137-310): corridor flows with
  Poisson spawning; v0 = max(0.8, 1.14 + sqrt(0.1)·N).
- ``GC`` (scenarios.py:313-401): Grand Central concourse — wall polyline
  sampled at 5 cm, circular obstacle R=2.75 at (13.52, 10.71), 7 entries,
  OD sampling with :func:`~piml_tpu_torch.gen.route.route` relay waypoints,
  v0 ~ max(0.7, N(1.34, 0.26)).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from piml_tpu_torch.gen.route import route
from piml_tpu_torch.gen.socialforce import Device, SpawnSchedule


def _schedule(spawn_frame, position, velocity, waypoints, dest_num,
              desired_speed, device: Device = "cuda:0") -> SpawnSchedule:
    def put(x, dtype):
        return torch.as_tensor(np.asarray(x, dtype), device=device)

    return SpawnSchedule(
        spawn_frame=put(spawn_frame, np.int32),
        position=put(position, np.float32),
        velocity=put(velocity, np.float32),
        waypoints=put(waypoints, np.float32),
        dest_num=put(dest_num, np.int32),
        desired_speed=put(desired_speed, np.float32),
    )


def _poisson_arrivals(rng, lam_per_s: float, time_unit: float,
                      num_frames: int) -> np.ndarray:
    """Frame index for each arriving agent."""
    counts = rng.poisson(lam_per_s * time_unit, size=num_frames)
    return np.repeat(np.arange(num_frames), counts)


def crosswalk(
    num_frames: int,
    length: float = 20.0,
    width: float = 7.0,
    num_ped1: int = 10,
    num_ped2: int = 10,
    time_unit: float = 0.08,
    uniform_desired_speed: bool = False,
    lam_per_s: float = 5.0,
    seed: int = 0,
    device: Device = "cuda:0",
) -> Tuple[SpawnSchedule, np.ndarray]:
    """Returns (schedule on ``device``, obstacles as numpy)."""
    rng = np.random.RandomState(seed)

    def generate(n):
        side_x = 2 * rng.randint(0, 2, n) - 1
        side_y = 2 * rng.randint(0, 2, n) - 1
        pos = np.stack([side_x * (length / 2 + 3 * rng.rand(n)),
                        width / 2 * side_y], axis=1)
        v0 = 1.34 * np.ones(n)
        if not uniform_desired_speed:
            v0 = v0 + np.sqrt(0.26) * rng.randn(n)
        vel = np.stack([np.zeros(n), -side_y * v0], axis=1)
        des_x1 = -side_x * length / 2
        des_y1 = -width / 2 + width * rng.randint(0, 2, n)
        wp = np.stack([np.stack([des_x1, des_y1], 1),
                       np.stack([des_x1, des_y1 * 3], 1)], axis=0)  # 2, n, 2
        return pos, vel, wp, v0

    arr = _poisson_arrivals(rng, lam_per_s, time_unit, num_frames)
    n0 = num_ped1 + num_ped2
    n_total = n0 + arr.size
    spawn_frame = np.concatenate([np.zeros(n0, np.int64), arr])
    pos, vel, wp, v0 = generate(n_total)
    dest_num = np.full(n_total, 2)
    obstacles = np.array([[1e4, 1e4], [1e4 + 1, 1e4 + 1]])
    sched = _schedule(spawn_frame, pos, vel, wp, dest_num, v0, device=device)
    return sched, obstacles


def four_directional_square(
    num_frames: int,
    block_length: float = 20.0,
    peds_density: int = 5,
    uniform_desired_speed: bool = True,
    seed: int = 0,
    device: Device = "cuda:0",
) -> Tuple[SpawnSchedule, np.ndarray]:
    rng = np.random.RandomState(seed)
    n = 4 * peds_density ** 2
    grid = (np.arange(1 - peds_density, peds_density + 1, 2)
            * block_length / 2 / peds_density)
    gx, gy = np.meshgrid(grid, grid, indexing="ij")
    gx, gy = gx.reshape(-1), gy.reshape(-1)
    pos = np.concatenate([
        np.stack([gx - block_length, gy], 1),
        np.stack([gx + block_length, gy], 1),
        np.stack([gx, gy - block_length], 1),
        np.stack([gx, gy + block_length], 1),
    ], axis=0)
    shuffle = rng.permutation(n // 4)
    des = np.concatenate([
        np.stack([gx[shuffle] + block_length, gy[shuffle]], 1),
        np.stack([gx[shuffle] - block_length, gy[shuffle]], 1),
        np.stack([gx[shuffle], gy[shuffle] + block_length], 1),
        np.stack([gx[shuffle], gy[shuffle] - block_length], 1),
    ], axis=0)[None]  # 1, n, 2
    v0 = 1.34 * np.ones(n)
    if not uniform_desired_speed:
        v0 = v0 + np.sqrt(0.26) * rng.randn(n)
    theta = np.linspace(-np.pi, np.pi, 128)
    obstacles = np.stack([5 * np.cos(theta), 5 * np.sin(theta)], axis=1)
    sched = _schedule(np.zeros(n), pos, np.zeros((n, 2)), des,
                      np.ones(n), v0, device=device)
    return sched, obstacles


def _basic_speed(rng, n, uniform):
    v0 = 1.14 * np.ones(n)
    if not uniform:
        v0 = v0 + np.sqrt(0.1) * rng.randn(n)
        v0[v0 < 0.8] = 0.8
    return v0


def basic_unit1(num_frames: int, length: float = 20.0, width: float = 10.0,
                time_unit: float = 0.08, poisson_lambda: float = 5.0,
                uniform_desired_speed: bool = True, seed: int = 0,
                device: Device = "cuda:0"):
    rng = np.random.RandomState(seed)
    arr = _poisson_arrivals(rng, poisson_lambda, time_unit, num_frames)
    n = 1 + arr.size
    spawn = np.concatenate([[0], arr])
    posy = width * rng.rand(n)
    pos = np.stack([np.zeros(n), posy], 1)
    v0 = _basic_speed(rng, n, uniform_desired_speed)
    vel = np.stack([v0.copy(), np.zeros(n)], 1)
    wp = np.stack([length * np.ones(n), posy + (2 * rng.rand(n) - 1)], 1)[None]
    obstacles = np.array([[1e4, 1e4], [1e4 + 1, 1e4 + 1]])
    sched = _schedule(spawn, pos, vel, wp, np.ones(n), v0, device=device)
    return sched, obstacles


def basic_unit2(num_frames: int, length: float = 20.0, width: float = 10.0,
                time_unit: float = 0.08, poisson_lambda: float = 5.0,
                side_ratio: float = 0.3, direction_ratio: float = 0.5,
                uniform_desired_speed: bool = True, seed: int = 0,
                device: Device = "cuda:0"):
    rng = np.random.RandomState(seed)
    arr = _poisson_arrivals(rng, poisson_lambda, time_unit, num_frames)
    n = 1 + arr.size
    spawn = np.concatenate([[0], arr])
    left = rng.rand(n) < side_ratio
    r2l = rng.rand(n) < direction_ratio
    posx = np.zeros(n)
    posy = width / 2 * rng.rand(n)
    posy[left] += width / 2
    posx[r2l] = length
    posy[r2l] = width - posy[r2l]
    pos = np.stack([posx, posy], 1)
    desx = length * np.ones(n)
    desy = posy + (2 * rng.rand(n) - 1)
    desx[r2l] = 0
    wp = np.stack([desx, desy], 1)[None]
    v0 = _basic_speed(rng, n, uniform_desired_speed)
    velx = v0.copy()
    velx[r2l] = -velx[r2l]
    vel = np.stack([velx, np.zeros(n)], 1)
    obstacles = np.array([[1e4, 1e4], [1e4 + 1, 1e4 + 1]])
    sched = _schedule(spawn, pos, vel, wp, np.ones(n), v0, device=device)
    return sched, obstacles


def basic_unit3(num_frames: int, length: float = 20.0, width: float = 10.0,
                time_unit: float = 0.08, poisson_lambda: float = 5.0,
                poisson_lambda2: float = 1.0,
                uniform_desired_speed: bool = True, seed: int = 0,
                device: Device = "cuda:0"):
    rng = np.random.RandomState(seed)
    arr1 = _poisson_arrivals(rng, poisson_lambda, time_unit, num_frames)
    arr2 = _poisson_arrivals(rng, poisson_lambda2, time_unit, num_frames)
    n1, n2 = 1 + arr1.size, arr2.size
    spawn = np.concatenate([[0], arr1, arr2])
    posa = np.stack([np.zeros(n1), width * rng.rand(n1)], 1)
    posb = np.stack([length * rng.rand(n2), np.zeros(n2)], 1)
    pos = np.concatenate([posa, posb], 0)
    desa = np.stack([length * np.ones(n1), posa[:, 1] + (2 * rng.rand(n1) - 1)], 1)
    desb = np.stack([posb[:, 0] + (2 * rng.rand(n2) - 1), width * np.ones(n2)], 1)
    wp = np.concatenate([desa, desb], 0)[None]
    v0 = _basic_speed(rng, n1 + n2, uniform_desired_speed)
    vel = np.concatenate([
        np.stack([v0[:n1], np.zeros(n1)], 1),
        np.stack([np.zeros(n2), v0[n1:]], 1),
    ], 0)
    obstacles = np.array([[1e4, 1e4], [1e4 + 1, 1e4 + 1]])
    sched = _schedule(spawn, pos, vel, wp, np.ones(n1 + n2), v0, device=device)
    return sched, obstacles


# ---------------------------------------------------------------------------
# Grand Central concourse
# ---------------------------------------------------------------------------

GC_WALL_NODES = np.array([
    [0, 0], [0, 5.63], [-5, 5.63], [-5, 16.01], [0, 16.01], [0, 35],
    [0, 40], [5.93, 40], [5.93, 35], [21.43, 35], [21.43, 40], [30, 40],
    [30, 35], [35, 35], [35, 29.48], [30, 29.48], [30, 25.62], [35, 25.62],
    [35, 18.99], [30, 18.99], [30, 14.79], [35, 14.79], [35, 7.07],
    [30, 7.07], [30, 0], [30, -5], [0, -5], [0, 0],
], dtype=np.float64)


def gc_geometry():
    """Wall polyline sampled at 5 cm + circular obstacle (scenarios.py:321-339)."""
    wall_len = np.linalg.norm(np.diff(GC_WALL_NODES, axis=0), axis=1)
    wall = []
    for i in range(GC_WALL_NODES.shape[0] - 1):
        k = int(wall_len[i] / 0.05)
        x = np.linspace(GC_WALL_NODES[i, 0], GC_WALL_NODES[i + 1, 0], k)
        y = np.linspace(GC_WALL_NODES[i, 1], GC_WALL_NODES[i + 1, 1], k)
        wall.append(np.stack([x, y], 1))
    wall = np.concatenate(wall, 0)
    theta = np.linspace(0, 2 * np.pi, 100)
    circle = np.stack([2.75 * np.cos(theta) + 13.52,
                       2.75 * np.sin(theta) + 10.71], axis=1)
    entries = [
        np.stack([np.zeros(100), np.linspace(5.63 + 1, 16.01 - 1, 100)], 1),
        np.stack([np.linspace(0 + 1, 5.93 - 1, 100), 35 * np.ones(100)], 1),
        np.stack([np.linspace(21.43 + 1, 30 - 1, 100), 35 * np.ones(100)], 1),
        np.stack([30 * np.ones(100), np.linspace(29.48 + 1, 35 - 1, 100)], 1),
        np.stack([30 * np.ones(100), np.linspace(18.99 + 1, 25.62 - 1, 100)], 1),
        np.stack([30 * np.ones(100), np.linspace(7.07 + 1, 14.79 - 1, 100)], 1),
        np.stack([np.linspace(0 + 1, 30 - 1, 100), np.zeros(100)], 1),
    ]
    return wall, circle, entries


def GC(num_frames: int, time_unit: float = 0.08,
       uniform_desired_speed: bool = False, initial_peds: int = 20,
       lam_per_s: float = 5.0, seed: int = 0, device: Device = "cuda:0"):
    rng = np.random.RandomState(seed)
    wall, circle, entries = gc_geometry()
    obstacles = np.concatenate([wall, circle], axis=0)

    arr = _poisson_arrivals(rng, lam_per_s, time_unit, num_frames)
    n = initial_peds + arr.size
    spawn = np.concatenate([np.zeros(initial_peds, np.int64), arr])

    pos = np.zeros((n, 2))
    wp = np.full((2, n, 2), np.nan)
    for i in range(n):
        o_e, d_e = rng.choice(len(entries), 2, replace=False)
        o = entries[o_e][rng.randint(100)] + rng.rand(2) * 0.8
        d = entries[d_e][rng.randint(100)] + rng.rand(2) * 0.8
        od = route(np.stack([o, d], 0), circle)  # 3, 1, 2
        pos[i] = od[0, 0]
        wp[0, i] = od[1, 0]
        wp[1, i] = od[2, 0]

    v0 = 1.34 * np.ones(n)
    if not uniform_desired_speed:
        v0 = v0 + np.sqrt(0.26) * rng.randn(n)
        v0[v0 < 0.7] = 0.7

    sched = _schedule(spawn, pos, np.zeros((n, 2)), wp, np.full(n, 2), v0,
                      device=device)
    return sched, obstacles


SCENARIOS = {
    "crosswalk": crosswalk,
    "four_directional_square": four_directional_square,
    "basic_unit1": basic_unit1,
    "basic_unit2": basic_unit2,
    "basic_unit3": basic_unit3,
    "GC": GC,
}

"""The Grand Central scenario's spawn schedule, drawn on the host with numpy.

The benchmark's own copy of the sampler of the reference's
``src/data/scenarios.py:313-401`` (github.com/tsinghua-fib-lab/PIML) and of
the relay-waypoint router of ``src/utils/utils.py:131-165`` that it calls,
so that the inputs of the social-force cell come from the benchmark and not
from the measured program.  A seed draws, with ``np.random.RandomState``:

- ``initial_peds`` pedestrians at frame 0, then Poisson arrivals at
  ``lam_per_s`` a second, ``Poisson(lam_per_s · time_unit)`` a frame;
- for each, two distinct entries of the seven, a point on each (shifted by
  up to 0.8 m), and a relay waypoint routed 2 m outside the central pillar
  where the straight walk would cross it;
- a desired speed ``max(0.7, N(1.34, 0.26))``, and velocity 0 at spawn.

The obstacles are the wall polyline sampled every 5 cm and the pillar's
100 points: the same 4,094 points for every seed.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

WALL_NODES = np.array([
    [0, 0], [0, 5.63], [-5, 5.63], [-5, 16.01], [0, 16.01], [0, 35],
    [0, 40], [5.93, 40], [5.93, 35], [21.43, 35], [21.43, 40], [30, 40],
    [30, 35], [35, 35], [35, 29.48], [30, 29.48], [30, 25.62], [35, 25.62],
    [35, 18.99], [30, 18.99], [30, 14.79], [35, 14.79], [35, 7.07],
    [30, 7.07], [30, 0], [30, -5], [0, -5], [0, 0],
], dtype=np.float64)


def gc_geometry():
    """The wall polyline sampled at 5 cm, the pillar (radius 2.75 m at
    (13.52, 10.71), 100 points) and the seven entries (100 points each)."""
    wall_len = np.linalg.norm(np.diff(WALL_NODES, axis=0), axis=1)
    wall = []
    for i in range(WALL_NODES.shape[0] - 1):
        k = int(wall_len[i] / 0.05)
        x = np.linspace(WALL_NODES[i, 0], WALL_NODES[i + 1, 0], k)
        y = np.linspace(WALL_NODES[i, 1], WALL_NODES[i + 1, 1], k)
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
        np.stack([30 * np.ones(100),
                  np.linspace(18.99 + 1, 25.62 - 1, 100)], 1),
        np.stack([30 * np.ones(100),
                  np.linspace(7.07 + 1, 14.79 - 1, 100)], 1),
        np.stack([np.linspace(0 + 1, 30 - 1, 100), np.zeros(100)], 1),
    ]
    return wall, circle, entries


def _cross_z(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``(a × b) · ẑ`` for rows of 2-D vectors."""
    return np.sum(np.stack([b[:, 1], -b[:, 0]], axis=1) * a, axis=1)


def route(od: np.ndarray, obs: np.ndarray, max_iters: int = 32) -> np.ndarray:
    """Origin, relay and destination, ``(3, 1, 2)``: the straight segment
    from ``od[0]`` to ``od[1]`` is reflected off the polyline ``obs`` until
    it crosses none of it, the relay 2 m outside the first crossing (the
    destination itself where the segment is clear)."""
    o = od[0:1, :].astype(np.float64)
    d = od[1:2, :].astype(np.float64)
    r = d.copy()
    for _ in range(max_iters):
        A = r - o
        B = np.diff(obs, axis=0)
        C = obs[:-1, :] - o
        with np.errstate(divide="ignore", invalid="ignore"):
            det = _cross_z(B, A)
            alpha = _cross_z(B, C) / det
            beta = _cross_z(A, C) / det
        hit = (0 < alpha) & (alpha < 1) & (0 < beta) & (beta < 1)
        hit &= np.isfinite(alpha) & np.isfinite(beta)
        if not hit.any():
            break
        idx = np.nonzero(hit)[0]
        seg = idx[np.argmin(alpha[idx])]
        cross = alpha[seg] * r + (1 - alpha[seg]) * o
        normal = -_cross_z(A, B[seg: seg + 1, :]) * np.stack(
            [A[:, 1], -A[:, 0]], axis=1)
        normal = normal / np.linalg.norm(normal, axis=1, keepdims=True)
        r = cross + 2 * normal
    return np.stack([o, r, d], axis=0)


def _poisson_arrivals(rng, lam_per_s: float, time_unit: float,
                      num_frames: int) -> np.ndarray:
    """The spawn frame of each arrival, in order."""
    counts = rng.poisson(lam_per_s * time_unit, size=num_frames)
    return np.repeat(np.arange(num_frames), counts)


def GC(num_frames: int, time_unit: float = 0.08, initial_peds: int = 20,
       lam_per_s: float = 5.0, seed: int = 0
       ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """One drawn schedule over ``num_frames`` frames and the obstacle
    points ``(4094, 2)``.  The schedule's arrays, one slot an agent:
    ``spawn_frame`` (N,) int32, ``position`` / ``velocity`` (N, 2) float32,
    ``waypoints`` (2, N, 2) float32, ``dest_num`` (N,) int32 (2: the relay,
    then the destination), ``desired_speed`` (N,) float32."""
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
        od = route(np.stack([o, d], 0), circle)
        pos[i] = od[0, 0]
        wp[0, i] = od[1, 0]
        wp[1, i] = od[2, 0]

    v0 = 1.34 * np.ones(n) + np.sqrt(0.26) * rng.randn(n)
    v0[v0 < 0.7] = 0.7
    sched = dict(spawn_frame=spawn.astype(np.int32),
                 position=pos.astype(np.float32),
                 velocity=np.zeros((n, 2), np.float32),
                 waypoints=wp.astype(np.float32),
                 dest_num=np.full(n, 2, np.int32),
                 desired_speed=v0.astype(np.float32))
    return sched, obstacles

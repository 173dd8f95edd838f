"""Polyline route planner around a polygonal obstacle.

A copy of ``piml_tpu/gen/route.py``.  Reference: src/utils/utils.py:131-165
— iteratively reflects the straight origin→destination segment off the
obstacle polyline until collision-free, yielding a waypoint 2 m outside the
first intersection.  Host-side numpy (runs once per agent at
scenario-generation time).
"""

from __future__ import annotations

import numpy as np


def cross_dot_z(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(a × b) · ẑ for rows of 2-D vectors."""
    b_cross_z = np.stack([b[:, 1], -b[:, 0]], axis=1)
    return np.sum(b_cross_z * a, axis=1)


def route(od: np.ndarray, obs: np.ndarray, max_iters: int = 32) -> np.ndarray:
    """Waypoints from ``od[0]`` to ``od[1]`` avoiding polyline ``obs``.

    Returns (3, 1, 2): origin, relay, destination (relay == destination when
    the straight segment is already clear).
    """
    o = od[0:1, :].astype(np.float64)
    d = od[1:2, :].astype(np.float64)
    r = d.copy()
    for _ in range(max_iters):
        A = r - o                      # 1, 2
        B = np.diff(obs, axis=0)       # M-1, 2
        C = obs[:-1, :] - o            # M-1, 2
        with np.errstate(divide="ignore", invalid="ignore"):
            det = cross_dot_z(B, A)
            alpha = cross_dot_z(B, C) / det
            beta = cross_dot_z(A, C) / det
        collision = (0 < alpha) & (alpha < 1) & (0 < beta) & (beta < 1)
        collision &= np.isfinite(alpha) & np.isfinite(beta)
        if not collision.any():
            break
        idx = np.nonzero(collision)[0]
        seg = idx[np.argmin(alpha[idx])]
        cross = alpha[seg] * r + (1 - alpha[seg]) * o
        normal = -cross_dot_z(A, B[seg: seg + 1, :]) * np.stack(
            [A[:, 1], -A[:, 0]], axis=1
        )
        normal = normal / np.linalg.norm(normal, axis=1, keepdims=True)
        r = cross + 2 * normal
    return np.stack([o, r, d], axis=0)

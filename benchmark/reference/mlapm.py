"""Plain PyTorch reference of MLAPM, the force law that "Physics-infused
Machine Learning for Crowd Simulation" (KDD'22) found by symbolic
regression, and of the generator that integrates it.

Written from the published description (github.com/tsinghua-fib-lab/PIML,
``src/models/mlapm.py:5-58`` for the law, ``src/main_mlapm.py:16-26`` for
the GC constants and the integration); it imports nothing of the measured
program.  The GC law: agent ``i`` with position ``p_i``, velocity ``v_i``,
desired speed ``s_i`` and goal direction ``e_i`` feels

    F_i = (s_i e_i − v_i) / τ
          − Σ_j g_ij A exp(B r + C cosφ + D r cosφ) R(±θ) r̂

over every other agent ``j``, where ``r = |p_j − p_i|``, ``r̂`` its unit
vector, ``φ`` the angle between ``p_j − p_i`` and ``v_j − v_i``, ``g_ij``
the front-view gate ``v_i · (p_j − p_i) > 0``, and ``R(±θ)`` the rotation
by ``θ`` whose sign is that of ``(p_j − p_i) × e_i`` (``+θ`` where the
cross product is 0).  There is no cut-off radius.  The generator steps
``v' = v + F dt`` and then ``p' = p + v' dt``, advances an agent's waypoint
when it ends a frame within ``arrive_distance`` of it, and retires the
agent past its last waypoint.

Departures from the published code, which steps a fixed set of live
agents: slots are fixed, and an absent slot (not yet spawned or retired)
has a NaN position and a zero velocity; it feels no force and exerts none,
where the published code would carry NaN through the sum.  Norms are
floored as the published code floors them: 1e-12 for the unit vectors,
1e-8 for the two norms of ``cosφ``.

The pair terms are taken ``ROW_BLOCK`` pair elements at a time, so the
reference fits beside the program's state on the card.  ``pair_dtype``
bfloat16 gives the benchmark's control: the differences ``p_j − p_i`` and
``v_j − v_i`` are taken in float32 and everything after them in bfloat16,
the sum over ``j`` in float32.  The law has no matrix product, so TF32
cannot be its lower precision.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

ROW_BLOCK = 2 ** 24     # pair elements per block of rows


class Law(NamedTuple):
    """The GC law's constants (θ in degrees)."""

    tau: float
    A: float
    B: float
    C: float
    D: float
    theta: float


def fp32_only() -> None:
    """No TF32 anywhere: the reference is float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _unit(x: torch.Tensor, floor: float) -> torch.Tensor:
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp_min(n, floor)


def repulsion(law: Law, p_rows, v_rows, e_rows, p, v, present,
              pair_dtype=torch.float32) -> torch.Tensor:
    """``Σ_j`` of the pair term on each of the ``rows`` agents:
    ``(R, 2)`` rows against every ``(N, 2)`` column; ``present`` (N,) bool
    marks the columns that exert a force."""
    rel = p[None, :, :] - p_rows[:, None, :]               # R, N, 2: p_j - p_i
    dv = v[None, :, :] - v_rows[:, None, :]
    here = present[None, :] & torch.isfinite(p_rows[:, :1])
    rel = torch.where(here[..., None], rel, 0.0).to(pair_dtype)
    dv = torch.where(here[..., None], dv, 0.0).to(pair_dtype)
    vi = v_rows.to(pair_dtype)[:, None, :]
    ei = e_rows.to(pair_dtype)[:, None, :]

    r = torch.linalg.vector_norm(rel, dim=-1)
    front = (vi * rel).sum(-1) > 0
    gate = here & front & (r > 0)
    unit = _unit(rel, 1e-12)
    cross = rel[..., 0] * ei[..., 1] - rel[..., 1] * ei[..., 0]
    sign = torch.where(cross > 0, -1.0, 1.0).to(pair_dtype)
    th = math.radians(law.theta)
    c, s = math.cos(th), math.sin(th)
    rot = torch.stack([c * unit[..., 0] - sign * s * unit[..., 1],
                       sign * s * unit[..., 0] + c * unit[..., 1]], dim=-1)
    cos_phi = ((rel * dv).sum(-1)
               / (torch.clamp_min(r, 1e-8)
                  * torch.clamp_min(torch.linalg.vector_norm(dv, dim=-1),
                                    1e-8)))
    mag = law.A * torch.exp(law.B * r + law.C * cos_phi
                            + law.D * r * cos_phi)
    term = torch.where(gate[..., None], mag[..., None] * rot, 0.0)
    return term.float().sum(dim=1)


def force(law: Law, p, v, desired_speed, dest,
          pair_dtype=torch.float32, block: Optional[int] = None
          ) -> torch.Tensor:
    """The force on every slot, ``(N, 2)``; 0 on absent slots.  ``block``:
    rows a block (default: ``ROW_BLOCK`` pair elements)."""
    n = p.shape[0]
    present = torch.isfinite(p[:, 0])
    e = _unit(torch.where(present[:, None], dest - p, 0.0), 1e-12)
    goal = (desired_speed[:, None] * e - v) / law.tau
    rows = block or max(1, ROW_BLOCK // max(n, 1))
    rep = torch.cat([repulsion(law, p[s:s + rows], v[s:s + rows],
                               e[s:s + rows], p, v, present, pair_dtype)
                     for s in range(0, n, rows)]) if n else goal
    return torch.where(present[:, None], goal - rep, 0.0)


class Run(NamedTuple):
    p: torch.Tensor        # (T, N, 2), NaN where absent
    v: torch.Tensor        # (T, N, 2)
    active: torch.Tensor   # (T, N) 0/1


@torch.no_grad()
def generate(law: Law, spawn_frame, position, velocity, waypoints, dest_num,
             desired_speed, frames: int, dt: float, arrive_distance: float,
             pair_dtype=torch.float32, block: Optional[int] = None) -> Run:
    """``frames`` frames of the generator over fixed slots: slot ``n``
    enters at frame ``spawn_frame[n]`` at ``position[n]`` with
    ``velocity[n]``, walks to ``waypoints[:dest_num[n], n]`` in turn and
    retires past the last.  Records each frame's state after its step."""
    n = position.shape[0]
    dev = position.device
    wp = torch.where(torch.isnan(waypoints), 0.0, waypoints)
    ids = torch.arange(n, device=dev)
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
        f = force(law, torch.where(active[:, None], p, math.nan), v,
                  desired_speed, dest, pair_dtype, block)
        v_new = torch.where(active[:, None], v + f * dt, 0.0)
        p_new = torch.where(active[:, None], p + v_new * dt, p)
        near = torch.linalg.vector_norm(p_new - dest, dim=-1) < arrive_distance
        idx = idx + (near & active).long()
        done = idx > last
        idx = torch.where(done, last, idx)
        active = active & ~done
        p = torch.where(active[:, None], p_new, math.nan)
        v = v_new
        ps.append(p)
        vs.append(v)
        acts.append(active.float())
    return Run(torch.stack(ps), torch.stack(vs), torch.stack(acts))

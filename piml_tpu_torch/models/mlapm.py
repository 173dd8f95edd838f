"""MLAPM — the discovered symbolic force model, as plain tensor force terms.

Counterpart of ``piml_tpu/models/mlapm.py`` (reference:
src/models/mlapm.py:5-58, the fitted constants in src/main_mlapm.py:16 —
GC: tau=0.5, A=7.55, B=-3.00, C=0.2, D=-0.3, theta=56° — and
src/utils/utils.py:47-93).  Three discovered force laws:

- ``raw``: ``A * exp(B * r)`` along -r̂, gated to the front half-plane;
- ``GC``: ``A * exp(B*r + C*cosθ + D*r*cosθ)`` with the repulsion direction
  rotated by the fitted angular bias ``theta``;
- ``UCY``: the exponential gated on a predicted collision within 1 s
  (minimum-distance-of-approach test).

:func:`mlapm_step` integrates ``v' = v + F·dt`` and the caller advances
``p' = p + v'·dt`` (non-lagged, unlike the NN rollout — see
src/main_mlapm.py:26 vs src/models/simulators.py:602-604).
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class MLAPMParams:
    version: str = "GC"
    tau: float = 0.5
    A: float = 7.55
    B: float = -3.00
    C: float = 0.2
    D: float = -0.3
    theta: float = 56.0  # degrees
    # UCY-version gating compat: the reference formula (mlapm.py:53) gives a
    # CONSTANT repulsion A·exp(0)=A to every in-view non-colliding pair
    # (coll=0 zeroes the exponent, not the magnitude), so crowds never settle.
    # True reproduces that formula; False applies the evident intent —
    # repulsion only when a collision is predicted within 1 s.
    ucy_gate_compat: bool = True

    @classmethod
    def gc_paper(cls) -> "MLAPMParams":
        """main_mlapm.py:16 constants."""
        return cls()

    @classmethod
    def gc2344_v2(cls) -> "MLAPMParams":
        """utils.py:80 constants (v2 iteration fit)."""
        return cls(version="GC", tau=0.5, A=9.00, B=-2.75, C=0.06, D=-0.3,
                   theta=10.0)

    @classmethod
    def ucy_v0(cls) -> "MLAPMParams":
        """utils.py:52 constants as the UCY-gated variant."""
        return cls(version="UCY", tau=5 / 6, A=10.67, B=-3.33, C=0.0, D=0.0,
                   theta=10.0)


def _normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """torch.nn.functional.normalize semantics: x / max(|x|, eps)."""
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp_min(n, eps)


def mlapm_force(
    params: MLAPMParams,
    position: torch.Tensor,
    velocity: torch.Tensor,
    desired_speed: torch.Tensor,
    destination: torch.Tensor,
    radius: float = 0.3,
) -> torch.Tensor:
    """Total force on each agent; NaN positions (absent agents) yield zero
    pairwise terms and NaN goal terms exactly like the reference (callers
    mask).

    position/velocity/destination: (N, 2); desired_speed: (N, 1) or (N,).
    """
    if desired_speed.ndim == 1:
        desired_speed = desired_speed[:, None]

    ed = _normalize(destination - position)
    force = (desired_speed * ed - velocity) / params.tau

    vr = position[None, :, :] - position[:, None, :]    # N, N, 2 (j - i)
    finite = torch.isfinite(vr).all(dim=-1, keepdim=True)
    vr_safe = torch.where(finite, vr, 0.0)
    r = torch.linalg.vector_norm(vr_safe, dim=-1, keepdim=True)  # N, N, 1
    # front-view gate: v_i · (p_j - p_i) > 0 (mlapm.py:27)
    vv = torch.where(torch.isfinite(velocity), velocity, 0.0)
    view = (torch.sum(vv[:, None, :] * vr_safe, dim=-1) > 0)[..., None]
    gate = view & finite & (r > 0)
    direc = _normalize(vr_safe)

    if params.version == "raw":
        mag = params.A * torch.exp(params.B * r)
    elif params.version in {"GC", "UCY"}:
        vv = vv[None, :, :] - vv[:, None, :]              # N, N, 2
        theta = (-torch.sign(vr_safe[..., 0] * ed[:, None, 1]
                             - vr_safe[..., 1] * ed[:, None, 0])
                 * params.theta / 180.0 * math.pi)
        theta = torch.where(theta == 0, params.theta / 180.0 * math.pi, theta)
        c, s = torch.cos(theta), torch.sin(theta)
        direc = torch.stack([c * direc[..., 0] - s * direc[..., 1],
                             s * direc[..., 0] + c * direc[..., 1]], dim=-1)
        if params.version == "GC":
            na = torch.clamp_min(torch.linalg.vector_norm(vr_safe, dim=-1),
                                 1e-8)
            nb = torch.clamp_min(torch.linalg.vector_norm(vv, dim=-1), 1e-8)
            cos = (torch.sum(vr_safe * vv, dim=-1) / (na * nb))[..., None]
            mag = params.A * torch.exp(params.B * r + params.C * cos
                                       + params.D * r * cos)
        else:  # UCY: collision-within-1s gate (mlapm.py:42-46)
            r2 = r[..., 0]
            coll = r2 < radius * 2
            coll |= (torch.linalg.vector_norm(vr_safe + vv * 1.0, dim=-1)
                     < radius * 2)
            vv2 = torch.clamp_min(torch.sum(vv * vv, dim=-1), 1e-12)
            rv = torch.sum(vr_safe * vv, dim=-1)
            tmin = -rv / vv2
            dmin2 = torch.sum(vr_safe * vr_safe, dim=-1) - rv ** 2 / vv2
            dmin = torch.sqrt(torch.clamp_min(dmin2, 0.0))
            coll |= (tmin > 0) & (tmin < 1) & (dmin < radius * 2)
            coll_f = coll.to(r.dtype)[..., None]
            mag = params.A * torch.exp(params.B * r * coll_f
                                       + params.C * coll_f)
            if not params.ucy_gate_compat:
                # intent gating: no predicted collision → no repulsion
                mag = mag * coll_f
    else:
        raise NotImplementedError(params.version)

    repulsion = torch.sum(torch.where(gate, mag * direc, 0.0), dim=1)
    return force - repulsion


def mlapm_step(
    params: MLAPMParams,
    position: torch.Tensor,
    velocity: torch.Tensor,
    desired_speed: torch.Tensor,
    destination: torch.Tensor,
    dt: float,
    radius: float = 0.3,
) -> torch.Tensor:
    """One velocity update ``v' = v + F·dt`` (reference: mlapm.py:57)."""
    f = mlapm_force(params, position, velocity, desired_speed, destination,
                    radius)
    return velocity + f * dt

"""Analytic social-force terms.

Counterpart of ``piml_tpu/physics/forces.py``:
:func:`pairwise_acceleration`, the fitted exponential repulsion family
v0/v1/v2 that supervises the messages when ``pinnsf_interaction='loss'``
(reference: src/utils/utils.py:31-100), and :func:`physical_pair_force`,
the classic Helbing repulsion.  The goal force lives with the model
(``models/zoo.py::goal_acceleration``).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

# Fitted constants per dataset (reference: src/utils/utils.py:47-93)
SF_CONSTANTS: Dict[str, Dict[str, Tuple[float, ...]]] = {
    "v0": {"gc1560": (8.75, -2.5), "gc2344": (8.75, -2.5),
           "ucy": (10.67, -3.33)},
    "v1": {"gc1560": (8.75, -2.5, 0.0), "gc2344": (8.75, -2.5, 0.0),
           "ucy": (10.67, -3.33, 0.0)},
    "v2": {"gc2344": (9.00, -2.75, 0.06, -0.3, 10 * 3.1415 / 180)},
}


def pairwise_acceleration(relative_data: torch.Tensor, version: str = "v0",
                          dataset: str = "gc1560", eps: float = 1e-6,
                          dv_from_velocity: bool = False) -> torch.Tensor:
    """Acceleration on agent i from neighbour j given relative (p, v)
    features ``(..., 4+)`` with [0:2] = p_j - p_i, [2:4] = v_j - v_i;
    returns (..., 2).

    Keeps the reference's quirk that v1/v2 read ``dv`` from the *position*
    channels (src/utils/utils.py:67,84), which makes ``cos`` ≡ 1;
    ``dv_from_velocity=True`` reads the velocity channels instead."""
    dr = relative_data[..., 0:2]
    r = torch.linalg.vector_norm(dr, dim=-1, keepdim=True) + eps
    direction = dr / r

    if version == "v0":
        A, B = SF_CONSTANTS["v0"][dataset]
        return -(A * torch.exp(B * r)) * direction

    dv = relative_data[..., 2:4] if dv_from_velocity else dr
    v = torch.linalg.vector_norm(dv, dim=-1, keepdim=True) + eps
    cos = (dr * dv).sum(dim=-1, keepdim=True) / r / v

    if version == "v1":
        A, B, C = SF_CONSTANTS["v1"][dataset]
        return -(A * torch.exp(B * r + C * cos)) * direction

    if version == "v2":
        A, B, C, D, theta = SF_CONSTANTS["v2"][dataset]
        acc = A * torch.exp(B * r + C * cos + D * r * cos)
        rot = torch.tensor([[math.cos(theta), -math.sin(theta)],
                            [math.sin(theta), math.cos(theta)]],
                           dtype=relative_data.dtype,
                           device=relative_data.device)
        direction = torch.einsum("ij,...j->...i", rot, direction)
        return -acc * direction

    raise NotImplementedError(version)


def physical_pair_force(rel_pos: torch.Tensor, intensity: float,
                        radius: float) -> torch.Tensor:
    """Helbing's repulsion ``A·exp(-r/B)·(-r̂)`` (knobs from the reference's
    src/configs/socialforce.yaml:72-80); ``rel_pos`` (..., 2) =
    p_other - p_self, NaN rows give zero force."""
    finite = torch.isfinite(rel_pos).all(dim=-1, keepdim=True)
    rel = torch.where(finite, rel_pos, 1.0)
    r = torch.linalg.vector_norm(rel, dim=-1, keepdim=True)
    r_safe = torch.clamp_min(r, 1e-6)
    force = -intensity * torch.exp(-r_safe / radius) * rel / r_safe
    return torch.where(finite & (r > 0), force, 0.0)

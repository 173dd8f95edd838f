"""Polar-coordinate transforms for rotation-invariant features.

Counterpart of ``piml_tpu/physics/polar.py`` (reference:
src/data/data.py:866-955, ``TimeIndexedPedDataPolarCoor``).  The polar
frame uses each agent's (normalized) heading as the polar axis; ``r >= 0``
and ``theta`` in [-pi, pi].  NaN inputs propagate to NaN outputs, matching
the reference.
"""

from __future__ import annotations

import torch


def cart_to_polar(points: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """Cartesian → polar about the normalized ``base`` axis.

    points/base: (..., 2) → (..., 2) as (r, theta) (reference:
    src/data/data.py:872-900; acos clamped to ±(1-1e-6), sign via the
    z-component of base × point).
    """
    volume = torch.linalg.vector_norm(points, dim=-1, keepdim=True)
    volume_safe = torch.where(volume == 0, volume + 0.1, volume)

    p = points / volume_safe
    cos_p, sin_p = p[..., 0], p[..., 1]
    cos_b, sin_b = base[..., 0], base[..., 1]
    sign = torch.sign(sin_p * cos_b - cos_p * sin_b)[..., None]

    cos_theta = torch.sum(points * base, dim=-1, keepdim=True) / volume_safe
    cos_theta = torch.clamp(cos_theta, -1 + 1e-6, 1 - 1e-6)
    theta = torch.arccos(cos_theta) * sign
    return torch.cat([volume, theta], dim=-1)


def polar_to_cart(points: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """Polar (about ``base``) → Cartesian (reference:
    src/data/data.py:903-920).

    Adds the base's own polar angle (w.r.t. the x-axis) to theta, then maps
    (r, theta) to (x, y).
    """
    cart_base = torch.zeros_like(base)
    cart_base[..., 0] = 1.0
    base_polar = cart_to_polar(base, cart_base)
    theta = points[..., 1] + base_polar[..., 1]
    r = points[..., 0]
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def features_to_polar(features: torch.Tensor,
                      heading: torch.Tensor) -> torch.Tensor:
    """Rewrite (..., k, 6) relative (p, v, a) features into the
    heading-aligned polar frame (reference: src/data/data.py:922-955)."""
    base = heading[..., None, :].expand(features[..., :2].shape)
    return torch.cat([cart_to_polar(features[..., 0:2], base),
                      cart_to_polar(features[..., 2:4], base),
                      cart_to_polar(features[..., 4:6], base)], dim=-1)

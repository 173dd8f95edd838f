"""Evaluation metrics: masked displacement error and collision counts.

Counterpart of ``piml_tpu/metrics/metrics.py`` (reference:
src/functions/metrics.py).  Sinkhorn OT and MMD are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from piml_tpu_torch.physics import collision_detection


def collision_count(position: torch.Tensor, threshold: float,
                    real_position: Optional[torch.Tensor] = None,
                    mode: str = "sum") -> torch.Tensor:
    """Contact count with friends filtering (reference: metrics.py:16-26)."""
    coll = collision_detection(position, threshold, real_position)
    if mode == "sum":
        return coll.sum()
    if mode == "mean":
        return coll.mean()
    return coll


def mae_with_time_mask(p: torch.Tensor, q: torch.Tensor, mask: torch.Tensor,
                       mode: str = "mean") -> torch.Tensor:
    """Masked mean/sum of per-agent L2 displacement error
    (reference: metrics.py:29-42)."""
    err = torch.linalg.vector_norm(
        torch.where(mask[..., None] == 1, p - q, 0.0), dim=-1)
    total = err.sum()
    if mode == "sum":
        return total
    return total / torch.clamp_min((mask == 1).sum(), 1)

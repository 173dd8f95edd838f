"""Loss library (reference: src/models/simulators.py:141-249).

Counterpart of ``piml_tpu/train/losses.py``: pure functions over masked
fixed-shape tensors.
"""

from __future__ import annotations

from typing import Optional

import torch


def reduction(values: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "sum":
        return values.sum()
    if mode == "mean":
        return values.mean()
    if mode == "none":
        return values
    raise NotImplementedError(mode)


def mse_loss(pred: torch.Tensor, labels: torch.Tensor,
             mode: str = "none") -> torch.Tensor:
    return reduction((pred - labels) ** 2, mode)


def l1_reg_loss(embeddings: torch.Tensor, weight: float = 1e-3,
                mode: str = "none") -> torch.Tensor:
    # |x| with the JAX package's derivative at 0 (``jnp.abs``: +1; torch's
    # ``abs`` gives 0): zero-feature neighbour slots of a zero-bias model
    # send exactly zero messages
    abs_e = torch.where(embeddings >= 0, embeddings, -embeddings)
    return reduction(weight * abs_e, mode)


def time_decay_weights(t_len: int, time_decay: float, reverse: bool = False,
                       dtype=torch.float32, device=None) -> torch.Tensor:
    """Exponential decay weights over the window (simulators.py:186-191)."""
    t = torch.arange(t_len, dtype=dtype, device=device)
    if not reverse:
        return time_decay ** (t_len - t - 1)
    return time_decay ** t


def multiple_rollout_mse_loss(pred: torch.Tensor, labels: torch.Tensor,
                              time_decay: float, mode: str = "none",
                              reverse: bool = False) -> torch.Tensor:
    """Squared error with exponential time decay (simulators.py:172-193).
    pred/labels: (c, t, n, 2)."""
    loss = (pred - labels) ** 2
    decay = time_decay_weights(pred.shape[1], time_decay, reverse,
                               pred.dtype, pred.device)
    return reduction(loss * decay.reshape(1, -1, 1, 1), mode)


def multiple_rollout_collision_avoidance_loss(
    pred: torch.Tensor, labels: torch.Tensor, time_decay: float,
    mode: str = "none",
) -> torch.Tensor:
    """Error projected perpendicular to each agent's window chord
    (simulators.py:227-249): removes the along-track component so the
    penalty targets lateral avoidance behaviour."""
    ni = labels[:, -1:, :, :] - labels[:, 0:1, :, :]
    ni = ni / (torch.linalg.vector_norm(ni, dim=-1, keepdim=True) + 1e-6)
    pred_perp = pred - (pred * ni).sum(dim=-1, keepdim=True) * ni
    labels_perp = labels - (labels * ni).sum(dim=-1, keepdim=True) * ni
    return multiple_rollout_mse_loss(pred_perp, labels_perp, time_decay, mode)


def multiple_rollout_collision_loss(
    pred: torch.Tensor, labels: torch.Tensor, time_decay: float,
    collisions: torch.Tensor, mode: str = "none",
    abnormal_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Perpendicular loss gated to agents that collided anywhere in the
    window (simulators.py:195-225).  The reference computes an MSE term it
    then discards (simulators.py:215-219); it is not computed here.

    collisions: (c, t, n) per-step contact counts.
    """
    w = (collisions.sum(dim=1) > 0).to(pred.dtype)[:, None, :, None]
    loss = w * multiple_rollout_collision_avoidance_loss(pred, labels,
                                                         time_decay)
    if abnormal_mask is not None:
        loss = loss * abnormal_mask.reshape(1, 1, -1, 1)
    return reduction(loss, mode)


def binary_cross_entropy(pred: torch.Tensor, target: torch.Tensor,
                         mode: str = "sum", eps: float = 1e-7) -> torch.Tensor:
    """``torch.nn.functional.binary_cross_entropy`` on probabilities,
    clamped as the JAX package clamps them."""
    p = torch.clamp(pred, eps, 1 - eps)
    loss = -(target * torch.log(p) + (1 - target) * torch.log(1 - p))
    return reduction(loss, mode)

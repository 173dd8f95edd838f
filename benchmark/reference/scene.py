"""Plain PyTorch reference of the per-scene quantities a recorded scene
gives its rollouts and training windows: each agent's desired speed, the
abnormal (turning or loitering) mask, the predictable-row mask and the
heading with its temporal zero-velocity fill.  Tracks are ``(T, N, ...)``
tensors, NaN where an agent is absent."""

from __future__ import annotations

import math

import torch

from benchmark.reference.crowd import heading_filled, nan0


def desired_speed(velocity: torch.Tensor, skip: int) -> torch.Tensor:
    """Mean speed over ``skip`` frames from each agent's first movement,
    the window clipped at the track's end: ``(T, N, 2) → (N,)``."""
    T = velocity.shape[0]
    speed = torch.linalg.vector_norm(velocity, dim=-1)
    moving = speed > 0
    start = torch.where(moving.any(0), torch.argmax(moving.to(torch.uint8), 0),
                        0)
    idx = start[None] + torch.arange(skip, device=velocity.device)[:, None]
    valid = idx < T
    win = torch.where(valid, torch.gather(speed, 0, torch.clamp_max(idx, T - 1)),
                      0.0)
    return win.sum(0) / torch.clamp_min(valid.sum(0), 1)


def shifted_and(mask: torch.Tensor, n_steps: int) -> torch.Tensor:
    """``mask`` and itself ``n_steps`` frames earlier: 1 where an agent has
    been present for the last ``n_steps + 1`` frames."""
    zeros = torch.zeros_like(mask[:n_steps])
    return torch.cat([zeros, mask[:mask.shape[0] - n_steps]], 0) * mask


def abnormal_mask(position, velocity, mask_v) -> torch.Tensor:
    """1 for an agent that walks straight: 0 where its chord turns more
    than 20° from its first velocity, or its mean speed is under 0.39 m/s."""
    present = torch.isfinite(position[..., 0])
    T = position.shape[0]
    anyp = present.any(0)
    first = torch.argmax(present.to(torch.uint8), 0)
    last = T - 1 - torch.argmax(torch.flip(present, [0]).to(torch.uint8), 0)
    ids = torch.arange(position.shape[1], device=position.device)
    ap = anyp[:, None]
    s = torch.where(ap, position[first, ids], 1e4)
    e = torch.where(ap, position[last, ids], 1e4)
    vs = torch.where(ap, velocity[first, ids], 1e4)
    chord = e - s
    cos = ((chord * vs).sum(-1) / (torch.linalg.vector_norm(chord, dim=-1)
                                   + 1e-6)
           / (torch.linalg.vector_norm(vs, dim=-1) + 1e-6))
    straight = ((cos >= math.cos(3.1415 * 20 / 180)) & (cos > 0)).to(
        position.dtype)
    speed = torch.linalg.vector_norm(nan0(velocity), dim=-1)
    mean = speed.sum(0) / torch.clamp_min(mask_v.sum(0), 1e-6)
    return torch.where(mean < 1.3 * 0.3, 0.0, straight)


def scene_terms(tracks: dict, skip: int) -> dict:
    """The per-scene quantities of a decoded scene (``tracks``: the
    benchmark's dense arrays as tensors)."""
    v = tracks["velocity"]
    return dict(
        heading=heading_filled(nan0(v)),
        desired_speed=desired_speed(v, skip),
        abnormal_mask=abnormal_mask(tracks["position"], v, tracks["mask_v"]),
        mask_p_pred=shifted_and(tracks["mask_p"], skip - 1),
    )

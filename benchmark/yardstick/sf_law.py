"""FLOPs of one pedestrian pair and one obstacle pair of the social-force
law (``reference/socialforce.py``), each term of the law listed once,
whatever the implementation computes again or folds away.  A fused
multiply-add counts 2; a square root, an exponential, a division and a
comparison each count 1.  The goal force and the integration are per
pedestrian and are left out: at ``N`` slots and ``M`` obstacle points they
are ``1/(N + M)`` of the pair work.

A sub-step evaluates every ordered pair of its ``N`` slots and every
(slot, obstacle point) pair, so a frame's work is ``oversampling ·
(PED_FLOPS · N² + OBS_FLOPS · N · M)``; ``mfu.sim`` divides the window's
work by its wall time and the card's f32 peak."""

from __future__ import annotations

# (term, FLOPs a pedestrian pair)
PED_TERMS = (
    ("relative position p_j - p_i", 2),
    ("r = |p_j - p_i|: two products, a sum, a root", 4),
    ("walking direction . (p_j - p_i)", 3),
    ("cosine: the product of the norms, the division", 2),
    ("against the sight angle's cosine", 1),
    ("A exp(-r / B): the division, exp, the factor A", 3),
    ("unit vector (p_j - p_i) / r", 2),
    ("magnitude times the unit vector", 2),
    ("sum over j", 2),
)

# (term, FLOPs an obstacle pair)
OBS_TERMS = (
    ("relative position o_m - p_i", 2),
    ("r = |o_m - p_i|: two products, a sum, a root", 4),
    ("A exp(-r / B): the division, exp, the factor A", 3),
    ("unit vector (o_m - p_i) / r", 2),
    ("magnitude times the unit vector", 2),
    ("sum over m", 2),
)

PED_FLOPS = sum(n for _, n in PED_TERMS)
OBS_FLOPS = sum(n for _, n in OBS_TERMS)


def frame_flops(slots: int, obstacles: int, oversampling: int) -> float:
    """The law's work in one frame of ``slots`` slots among ``obstacles``
    points."""
    return float(oversampling) * (PED_FLOPS * slots * slots
                                  + OBS_FLOPS * slots * obstacles)

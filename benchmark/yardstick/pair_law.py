"""FLOPs of one pair of the MLAPM GC law (``reference/mlapm.py``), each term
of the law listed once, whatever the implementation computes again or
folds away.  A fused multiply-add counts 2; a square root, an exponential,
a division and a sign each count 1.  The self-propulsion term is per agent
and is left out: at N agents it is ``1/N`` of the pair work.

A frame of the generator evaluates every ordered pair of its ``N`` slots,
so its work is ``PAIR_FLOPS · N²``; ``mfu.sim`` divides the window's work
by its wall time and the card's f32 peak."""

from __future__ import annotations

# (term, FLOPs a pair)
TERMS = (
    ("relative position p_j - p_i", 2),
    ("r = |p_j - p_i|: two products, a sum, a root", 4),
    ("front-view gate v_i . (p_j - p_i)", 3),
    ("unit vector (p_j - p_i) / r", 2),
    ("relative velocity v_j - v_i", 2),
    ("side of the goal: cross product (p_j - p_i) x e_i and its sign", 4),
    ("rotation of the unit vector by +-theta", 6),
    ("|v_j - v_i|", 4),
    ("cos phi: the dot product, the product of the norms, the division", 5),
    ("exponent B r + C cos phi + D r cos phi", 6),
    ("exp and the factor A", 2),
    ("magnitude times the rotated direction", 2),
    ("sum over j", 2),
)

PAIR_FLOPS = sum(n for _, n in TERMS)


def frame_flops(agents: int) -> float:
    """The law's work in one frame of ``agents`` slots."""
    return float(PAIR_FLOPS) * agents * agents

"""The numbers that decide ``correct`` for scoring cells: the program's
scores of an evaluation against the plain reference's, worst over the
checked units.

``mse_gap``, ``mae_gap``, ``ot_gap`` and ``mmd_gap``: the relative gap of
each mean score, ``|program − reference| ÷ |reference|``;
``collision_gap``: the larger absolute gap of the two contact totals (a
count the program takes exactly).  A score that is NaN or infinite on
either side reads +inf.  The cell's limits file decides which of them are
judged (``pinnsf_bm.dense_eval`` leaves ``mmd_gap`` out: at dataset
density the MMD sits at the program's float32 noise)."""

from __future__ import annotations

import math
from typing import Dict, Iterable

RELATIVE = ("mse", "mae", "ot", "mmd")
COUNTS = ("collision", "hard_collision")


def _gap(a: float, b: float, scale: float) -> float:
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / scale


def score_numbers(pairs: Iterable) -> Dict[str, float]:
    """``pairs``: ``(program, reference)`` score dicts per checked unit."""
    out = {f"{k}_gap": 0.0 for k in RELATIVE}
    out["collision_gap"] = 0.0
    seen = False
    for prog, ref in pairs:
        seen = True
        for k in RELATIVE:
            g = _gap(prog[k], ref[k], max(abs(ref[k]), 1e-30))
            out[f"{k}_gap"] = max(out[f"{k}_gap"], g)
        for k in COUNTS:
            out["collision_gap"] = max(out["collision_gap"],
                                       _gap(prog[k], ref[k], 1.0))
    if not seen:
        return {k: math.inf for k in out}
    return out

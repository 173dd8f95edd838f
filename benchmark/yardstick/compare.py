"""The numbers that decide ``correct``: the program's outputs against the
plain reference's, and each number against its limit.

Rollouts (every frame of a checked episode): ``pos_gap_max_m``, the
widest position gap over the agent-frames present on either side (an
agent present on one side only reads +inf); ``acc_gap_p90``, the 90th
percentile over those agent-frames of the acceleration gap in units of
the reference's RMS acceleration (a selection flip moves a few agents,
a lower precision every one).

Training (the first three steps): ``loss_gap``, the widest relative gap
of a step's loss; ``grad_gap``, the worst leaf's gap between the norms of
the first gradient as the optimizer takes it, over the larger of that
leaf's and the median leaf's reference norm; ``change_gap``, the same for
the parameters' change over the three steps, over the leaves whose
reference gradient is at least a thousandth of the median leaf's (the
rest move by round-off alone).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List

import torch


def rollout_numbers(pairs: Iterable) -> Dict[str, float]:
    """``pairs``: ``(program, reference)`` per checked episode, each a dict
    with ``p`` and ``a`` ``(T, N, 2)`` (NaN position = absent)."""
    pos_max = 0.0
    gaps: List[torch.Tensor] = []
    for prog, ref in pairs:
        pp, rp = prog["p"].float(), ref["p"].float()
        here_p = ~torch.isnan(pp[..., 0])
        here_r = ~torch.isnan(rp[..., 0])
        if bool((here_p != here_r).any()):
            pos_max = math.inf
        both = here_p & here_r
        if bool(both.any()):
            d = torch.linalg.vector_norm(pp - rp, dim=-1)[both]
            pos_max = max(pos_max, float(d.max()))
            a_ref = ref["a"].float()[both]
            rms = float(torch.sqrt((a_ref * a_ref).sum(-1).mean()))
            da = torch.linalg.vector_norm(prog["a"].float()[both] - a_ref, dim=-1)
            gaps.append(da / max(rms, 1e-12))
    out = {"pos_gap_max_m": pos_max}
    if gaps:
        out["acc_gap_p90"] = float(torch.quantile(torch.cat(gaps).double(), 0.9))
    else:
        out["acc_gap_p90"] = math.inf
    return out


def _leaf_gap(got: Dict[str, float], ref: Dict[str, float],
              keys: List[str]) -> float:
    """The worst leaf's gap; a leaf the program lacks or reads NaN on
    reads +inf."""
    med = statistics.median(ref[k] for k in ref)
    worst = 0.0
    for k in keys:
        g = got.get(k, math.nan)
        gap = abs(g - ref[k]) / max(ref[k], med, 1e-30)
        worst = max(worst, math.inf if math.isnan(gap) else gap)
    return worst


def training_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` / ``ref``: ``losses`` (3 floats), ``grad_norms`` and
    ``change_norms`` ({leaf: float})."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(prog["losses"], ref["losses"]))
    if any(not math.isfinite(x) for x in prog["losses"]):
        loss_gap = math.inf
    g_ref = ref["grad_norms"]
    med = statistics.median(g_ref.values())
    moving = [k for k in g_ref if g_ref[k] >= 1e-3 * med]
    return {
        "loss_gap": loss_gap,
        "grad_gap": _leaf_gap(prog["grad_norms"], g_ref, list(g_ref)),
        "change_gap": _leaf_gap(prog["change_norms"], ref["change_norms"],
                                moving),
    }


def judge(numbers: Dict[str, float], limits: Dict[str, dict]) -> List[dict]:
    """Each number that has a limit, with its limit and verdict; a number
    that is NaN or missing fails."""
    out = []
    for name, lim in limits.items():
        v = numbers.get(name, math.nan)
        ok = (not math.isnan(v)) and v <= lim["limit"]
        out.append({"name": name, "value": v, "limit": lim["limit"], "ok": ok})
    return out

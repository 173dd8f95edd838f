"""The least time of the neighbour selection, whatever implements it.

A pass selects, for each row (an agent: position and heading), the k
nearest objects in view within the radius.  It must at least read each
row's position and heading and each object's position once and write k
ids and k distances per row, at the card's memory bandwidth; and it must
at least test every pair within the radius of a row, at 6 f32 operations
a pair (difference ×2, squares ×2, sum, compare) without fused
multiply-adds.  The least time is the larger of the two.  Neither count
depends on how a kernel tiles, bins or windows the work, nor on which
route (a kernel or plain operations) the program takes for a pass: every
pass that a frame needs counts.
"""

from __future__ import annotations

from typing import Optional

import torch

OPS_PER_PAIR = 6
ROW_BYTES = 4 * 4           # position and heading, f32
OBJECT_BYTES = 2 * 4        # position, f32
OUT_BYTES_PER_SLOT = 4 + 4  # id (int32) and distance (f32)


@torch.no_grad()
def pairs_within(rows: torch.Tensor, objects: Optional[torch.Tensor],
                 radius: float) -> int:
    """Pairs (row, object) within ``radius``; ``objects`` None: the rows
    themselves, each unordered pair counted from both rows, no self pair.
    Absent (NaN) rows or objects never pair."""
    same = objects is None
    obj = rows if same else objects
    live_r = rows[~torch.isnan(rows).any(-1)]
    live_o = obj[~torch.isnan(obj).any(-1)]
    total = 0
    block = max(1, 2 ** 24 // max(live_o.shape[0], 1))
    r2 = radius * radius
    for s in range(0, live_r.shape[0], block):
        d = live_r[s:s + block, None, :] - live_o[None, :, :]
        total += int(((d * d).sum(-1) <= r2).sum())
    if same:
        total -= live_r.shape[0]
    return total


def pass_cost(rows: torch.Tensor, objects: Optional[torch.Tensor], k: int,
              radius: float) -> dict:
    """Bytes and operations of one pass over one frame ``rows (N, 2)``."""
    n = rows.shape[0]
    m = n if objects is None else objects.shape[0]
    nbytes = n * ROW_BYTES + m * OBJECT_BYTES + n * min(k, m) * OUT_BYTES_PER_SLOT
    ops = OPS_PER_PAIR * pairs_within(rows, objects, radius)
    return {"bytes": nbytes, "ops": ops}


def least_seconds(costs, peaks: dict) -> float:
    """Sum over passes of max(bytes / bandwidth, operations / op rate)."""
    return sum(max(c["bytes"] / peaks["hbm_bytes_per_s"],
                   c["ops"] / peaks["f32_ops_nofma"]) for c in costs)


def frame_costs(pos: torch.Tensor, obstacles: torch.Tensor, nb: dict) -> list:
    """The two passes of one frame ``(N, 2)``: agents and obstacles."""
    return [pass_cost(pos, None, nb["topk_ped"], nb["dist_threshold_ped"]),
            pass_cost(pos, obstacles, nb["topk_obs"], nb["dist_threshold_obs"])]

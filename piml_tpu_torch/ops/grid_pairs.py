"""Cell-list (spatial grid) support for the banded selector.

Counterpart of ``piml_tpu/ops/grid_pairs.py``: the static grid size and the
cell index (sorted object ids, per-cell offsets, quantile-robust origin and
cell size) that ``ops/banded.py`` builds its windows and exactness proof on.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def auto_grid_dim(m: int, k: int, fine: bool = False) -> int:
    """Static grid dimension targeting ~k objects per cell (1.5× finer when
    a ``dist_threshold`` backs the exactness predicate)."""
    g = math.sqrt(max(m, 1) / max(k, 1))
    if fine:
        g *= 1.5
    return max(4, min(512, int(g)))


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim f32 tensor on ``like``'s device: dividing by it is a true
    division (PyTorch turns division by a host scalar into a multiply by
    its reciprocal, which may round differently)."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def cell_coords(points: torch.Tensor, lo: torch.Tensor, cs: torch.Tensor,
                grid_dim: int) -> torch.Tensor:
    """``clip(floor((p − lo) / cs), 0, G − 1)`` as f32 — the expression the
    banded kernel evaluates in-kernel, so host and kernel boxes agree."""
    return torch.clamp(torch.floor((points - lo) / cs), 0.0, grid_dim - 1.0)


def build_cell_index(objects: torch.Tensor, grid_dim: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """Bin ``objects`` (M, 2; NaN = absent) into a G×G grid.

    Returns ``(order, offsets, lo, cell_size)``: ``order`` (M,) object ids
    sorted by cell id, invalid objects last (cell G·G); ``offsets``
    (G·G + 2,) exclusive prefix starts per cell; ``lo`` / ``cell_size``
    (2,) grid origin and per-axis cell size.  The grid spans the
    [0.5 %, 99.5 %] coordinate quantiles, so runaway agents clip into edge
    cells instead of collapsing the crowd into one cell.
    """
    g = grid_dim
    valid = torch.isfinite(objects).all(dim=-1)
    masked = torch.where(valid[:, None], objects, math.nan)
    q = torch.tensor([0.005, 0.995], dtype=objects.dtype,
                     device=objects.device)
    qs = torch.nanquantile(masked, q, dim=0, interpolation="linear")
    lo, hi = qs[0], qs[1]
    empty = ~valid.any()
    lo = torch.where(empty | torch.isnan(lo), 0.0, lo)
    hi = torch.where(empty | torch.isnan(hi), 1.0, hi)
    cell_size = torch.clamp_min((hi - lo) / _scalar(g, objects), 1e-6)

    cc = cell_coords(objects, lo, cell_size, g)
    cc = torch.where(valid[:, None], cc, 0.0).long()
    cid = torch.where(valid, cc[:, 0] * g + cc[:, 1], g * g)
    order = torch.argsort(cid, stable=True)
    counts = torch.bincount(cid, minlength=g * g + 1)
    offsets = torch.cat([torch.zeros(1, dtype=torch.long,
                                     device=objects.device),
                         torch.cumsum(counts, 0)])
    return order, offsets, lo, cell_size

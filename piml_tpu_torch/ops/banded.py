"""K2: banded cell-list field-of-view top-k — O(N · window) per frame.

Replaces the Pallas kernels ``piml_tpu/ops/banded.py:116`` (``_kernel``)
and ``:128`` (``_kernel_dma``), which share ``_tile_compute``, with
``csrc/banded_topk.cu``.  The TPU split into a VMEM-resident and a DMA
variant existed only for VMEM capacity; here the cell-sorted table lives
in device memory and every tile reads its window through shared memory,
so one kernel covers both.

Host side (plain tensor code, as in the JAX package):

1. bin the objects into a static G×G grid and lay them out in cell order
   (:func:`build_object_index`);
2. sort the agents by their own cell, so a tile of 128 consecutive rows is
   spatially coherent and its 5×5 cell boxes lie in ONE contiguous window
   of the sorted table, starting at ``ws[tile] · 128``;
3. the kernel scores the window with K1's distance and FOV math plus the
   5×5 box mask, keeping ties to the lowest ORIGINAL object id;
4. un-sort, then prove exactness: every row's k-th distance lies inside
   the unexamined-region bound (or the box covers the grid, or — with
   ``dist_threshold`` — the bound exceeds the threshold), and no tile's
   window overflowed.  :func:`topk_neighbors_banded_or_dense` reads that
   flag on the host once per frame and recomputes with the dense path
   when it is false.

On the card the kernel is bound by its N · window pair arithmetic; the
window (~1.8k columns for agents at N = 12,685) replaces K1's N columns.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from piml_tpu_torch import _build
from piml_tpu_torch.ops.grid_pairs import (auto_grid_dim, build_cell_index,
                                           cell_coords)
from piml_tpu_torch.ops.pairwise import (MAX_K, cos_threshold, pack_rows,
                                         pair_d2)

KERNEL = _build.KernelCount()
LANE = 128      # window starts are in units of LANE columns
TILE_N = 128    # agent rows per tile (one block on the card)
_BOUND_TOL = 1e-3


class ObjectIndex(NamedTuple):
    """Cell-sorted object table; build it once for a static table."""

    cols: torch.Tensor     # (6, m_band) [x; y; valid; oid; cx; cy]
    offsets: torch.Tensor  # (G·G + 2,) per-cell starts in the sorted order
    lo: torch.Tensor       # (2,) grid origin
    cs: torch.Tensor       # (2,) per-axis cell size
    order: torch.Tensor    # (M,) object ids in cell-sorted order


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def auto_window(n: int, m: int, grid_dim: int, tile_n: int = TILE_N) -> int:
    """Static per-tile column window: a tile spans ``tile_n·G²/n`` cells,
    so its 5×5 boxes cover ``5 + span/G (+1)`` cell rows of ``m/G``
    objects each; 1.3× slack absorbs occupancy fluctuation."""
    g = grid_dim
    row_width = m / g
    span_rows = (tile_n * g * g / max(n, 1)) / g
    want = (5.0 + span_rows + 1.0) * row_width * 1.3 + LANE
    return min(_round_up(max(int(want), LANE), LANE), _round_up(m, LANE))


def banded_params(n: int, m: int, k: int, grid_dim: Optional[int] = None,
                  window: Optional[int] = None,
                  fine: bool = False) -> Tuple[int, int]:
    """Static ``(grid_dim, window)`` for these shapes; ``fine`` mirrors
    whether a ``dist_threshold`` will be passed."""
    if grid_dim is None:
        grid_dim = auto_grid_dim(m, k, fine=fine)
    if window is None:
        window = auto_window(n, m, grid_dim)
    return grid_dim, window


def m_band(m: int, window: int) -> int:
    """Padded width of the sorted table: any window start plus ``window``
    stays inside it."""
    return _round_up(max(m, LANE), LANE) + window


def build_object_index(objects: torch.Tensor, grid_dim: int,
                       window: int) -> ObjectIndex:
    """Cell-sort an object table into the kernel's column layout."""
    g = grid_dim
    m = objects.shape[0]
    obj_valid = torch.isfinite(objects).all(dim=-1)
    obj = torch.where(obj_valid[:, None], objects, 0.0)
    order, offsets, lo, cs = build_cell_index(objects, g)
    obj4 = torch.cat([
        obj, obj_valid.float()[:, None],
        torch.arange(m, dtype=torch.float32, device=objects.device)[:, None],
    ], dim=1)
    sorted4 = obj4[order]
    scc = cell_coords(sorted4[:, :2], lo, cs, g)
    cols = torch.zeros((6, m_band(m, window)), dtype=torch.float32,
                       device=objects.device)
    cols[:, :m] = torch.cat([sorted4, scc], dim=1).T
    return ObjectIndex(cols=cols, offsets=offsets, lo=lo, cs=cs, order=order)


def banded_topk_plain(ws: torch.Tensor, geo: torch.Tensor, rows: torch.Tensor,
                      cols: torch.Tensor, window: int, grid_dim: int, k: int,
                      cos_thr: float, self_pairs: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2: gather each tile's window, score every pair by
    direct differencing, then a stable sort on ``(d2, original id)``."""
    dev = rows.device
    n_pad = rows.shape[0]
    num_tiles = n_pad // TILE_N
    thr = torch.tensor(cos_thr, dtype=torch.float32, device=dev)
    col_idx = (ws.long()[:, None] * LANE
               + torch.arange(window, device=dev)[None, :])      # T, W
    blk = cols[:, col_idx]                                         # 6, T, W
    r = rows.view(num_tiles, TILE_N, 8)
    xa, ya = r[..., 0:1], r[..., 1:2]
    axa = cell_coords(xa, geo[0], geo[2], grid_dim)
    aya = cell_coords(ya, geo[1], geo[3], grid_dim)
    xb, yb, vb, oid, cxb, cyb = (blk[c][:, None, :] for c in range(6))
    self_pair = (oid == r[..., 5:6]) if self_pairs else None
    d2 = pair_d2(xa, ya, r[..., 2:3], r[..., 3:4], xb, yb, self_pair, thr)
    in_box = ((torch.abs(cxb - axa) <= 2.0)
              & (torch.abs(cyb - aya) <= 2.0))
    invalid = (r[..., 4:5] < 0.5) | (vb < 0.5) | ~in_box
    d2 = torch.where(invalid, math.inf, d2)                       # T, TN, W
    # lexicographic (d2, oid): order the window by oid, then stable-sort d2
    perm = torch.argsort(blk[3], dim=-1, stable=True)              # T, W
    perm3 = perm[:, None, :].expand_as(d2)
    d2s, pos = torch.sort(torch.gather(d2, 2, perm3), dim=-1, stable=True)
    top = d2s[..., :k]
    ids = torch.gather(blk[3][:, None, :].expand_as(d2), 2,
                       torch.gather(perm3, 2, pos[..., :k]))
    out_d = torch.sqrt(top).reshape(n_pad, k)
    out_i = torch.where(torch.isfinite(top), ids, 0.0).int().reshape(n_pad, k)
    return out_d, out_i


def banded_topk_cuda(ws: torch.Tensor, geo: torch.Tensor, rows: torch.Tensor,
                     cols: torch.Tensor, window: int, grid_dim: int, k: int,
                     cos_thr: float, self_pairs: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/banded_topk.cu`` on PyTorch's current stream."""
    n_pad = rows.shape[0]
    mb = cols.shape[1]
    for name, t, dt in (("ws", ws, torch.int32), ("geo", geo, torch.float32),
                        ("rows", rows, torch.float32),
                        ("cols", cols, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"banded_topk: {name} must be {dt}")
        if not t.is_contiguous():
            raise ValueError(f"banded_topk: {name} must be contiguous")
        if t.device != rows.device:
            raise ValueError(f"banded_topk: {name} on {t.device}, "
                             f"rows on {rows.device}")
    if (n_pad % TILE_N or rows.shape != (n_pad, 8) or cols.shape[0] != 6
            or geo.shape != (4,) or ws.shape != (n_pad // TILE_N,)):
        raise ValueError("banded_topk: bad shapes")
    if window <= 0 or mb < window + LANE:
        raise ValueError(f"banded_topk: window {window} vs table {mb}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"banded_topk: k={k} outside [1, {MAX_K}]")
    if rows.device.type != "cuda":
        raise ValueError(f"banded_topk: the kernel needs CUDA tensors, "
                         f"got {rows.device}")
    lib = _build.LIBRARY.get()
    out_d = torch.empty((n_pad, k), dtype=torch.float32, device=rows.device)
    out_i = torch.empty((n_pad, k), dtype=torch.int32, device=rows.device)
    status = lib.piml_banded_topk(
        ws.data_ptr(), geo.data_ptr(), rows.data_ptr(), n_pad,
        cols.data_ptr(), mb, window, grid_dim, cos_thr, int(self_pairs), k,
        out_d.data_ptr(), out_i.data_ptr(), _build.stream_handle(rows.device))
    _build.check(status, "piml_banded_topk")
    KERNEL.launches += 1
    return out_d, out_i


def banded_topk(ws, geo, rows, cols, window, grid_dim, k, cos_thr,
                self_pairs):
    """K2 on packed inputs: the plain version for a CPU tensor, the kernel
    for a CUDA tensor (which raises rather than fall back)."""
    fn = banded_topk_plain if rows.device.type == "cpu" else banded_topk_cuda
    return fn(ws, geo, rows, cols, window, grid_dim, k, cos_thr, self_pairs)


def topk_neighbors_banded(
    position: torch.Tensor,
    heading: torch.Tensor,
    k: int,
    angle_threshold: float,
    objects: Optional[torch.Tensor] = None,
    same_objects: bool = True,
    grid_dim: Optional[int] = None,
    window: Optional[int] = None,
    dist_threshold: Optional[float] = None,
    index: Optional[ObjectIndex] = None,
    agent_order: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Banded FOV top-k: ``(dist (N, k'), idx (N, k'), exact ())``.

    Same contract as ``topk_neighbors_pallas`` plus the device-side
    ``exact`` flag.  ``index``: a prebuilt :func:`build_object_index` for a
    static object table (``objects`` then only gives its shape).
    ``agent_order``: a precomputed ``(order, inverse)`` agent sort shared
    between the passes of one frame.
    """
    if objects is None:
        objects = position
        same_objects = True
    n = position.shape[0]
    m = objects.shape[0]
    k_eff = min(k, m)
    g, window = banded_params(n, m, k, grid_dim, window,
                              fine=dist_threshold is not None)

    rows_unsorted = pack_rows(position, heading)
    pos = rows_unsorted[:, 0:2]
    pos_valid = rows_unsorted[:, 4] > 0.5

    if index is None:
        index = build_object_index(objects, g, window)
    elif (index.cols.shape[1] != m_band(m, window)
          or index.offsets.shape[0] != g * g + 2):
        raise ValueError(
            f"prebuilt ObjectIndex does not match banded params "
            f"(grid_dim={g}, window={window}); build it with "
            f"build_object_index(objects, *banded_params(...))")
    offsets, lo, cs = index.offsets, index.lo, index.cs

    # agents sorted by their cell in the OBJECT grid; invalid agents pinned
    # to the last cell so they sort to the end
    acell = cell_coords(pos, lo, cs, g).long()
    acell = torch.where(pos_valid[:, None], acell, g - 1)
    if agent_order is not None:
        aorder, inv = agent_order
    else:
        if same_objects:
            aorder = index.order
        else:
            aorder = torch.argsort(acell[:, 0] * g + acell[:, 1], stable=True)
        inv = torch.empty_like(aorder)
        inv[aorder] = torch.arange(n, device=position.device)

    n_pad = _round_up(max(n, TILE_N), TILE_N)
    # pad by repeating the last sorted agent (valid = 0) so padded rows do
    # not stretch the tile windows
    aidx = torch.cat([aorder, aorder[-1:].expand(n_pad - n)])
    rows = rows_unsorted[aidx]
    rows[n:, 4] = 0.0

    # per-tile windows (invalid rows pinned to the last cell row)
    num_tiles = n_pad // TILE_N
    ax_sorted = cell_coords(rows[:, 0], lo[0], cs[0], g).long()
    ax_sorted = torch.where(rows[:, 4] > 0.5, ax_sorted, g - 1)
    ax_t = ax_sorted.view(num_tiles, TILE_N)
    cx0 = torch.clamp(ax_t.min(dim=1).values - 2, 0, g - 1)
    cx1 = torch.clamp(ax_t.max(dim=1).values + 2, 0, g - 1)
    win_start_lanes = offsets[cx0 * g] // LANE
    win_end = offsets[(cx1 + 1) * g]
    tile_ok = (win_end - win_start_lanes * LANE) <= window

    geo = torch.stack([lo[0], lo[1], cs[0], cs[1]]).contiguous()
    out_d, out_i = banded_topk(
        win_start_lanes.int().contiguous(), geo, rows.contiguous(),
        index.cols, window, g, k_eff, cos_threshold(angle_threshold),
        same_objects)
    top_d = out_d[:n][inv]
    top_i = out_i[:n][inv]

    # exactness predicate (grid_pairs' box semantics)
    ax, ay = acell[:, 0], acell[:, 1]
    bx_lo = lo[0] + (ax - 2).float() * cs[0]
    bx_hi = lo[0] + (ax + 3).float() * cs[0]
    by_lo = lo[1] + (ay - 2).float() * cs[1]
    by_hi = lo[1] + (ay + 3).float() * cs[1]
    d_left = torch.where(ax - 2 > 0, pos[:, 0] - bx_lo, math.inf)
    d_right = torch.where(ax + 2 < g - 1, bx_hi - pos[:, 0], math.inf)
    d_down = torch.where(ay - 2 > 0, pos[:, 1] - by_lo, math.inf)
    d_up = torch.where(ay + 2 < g - 1, by_hi - pos[:, 1], math.inf)
    bound = torch.clamp_min(
        torch.minimum(torch.minimum(d_left, d_right),
                      torch.minimum(d_down, d_up)), 0.0)
    covered = ((ax - 2 <= 0) & (ax + 2 >= g - 1)
               & (ay - 2 <= 0) & (ay + 2 >= g - 1))
    kth = top_d[:, k_eff - 1]
    ok = covered | (kth < bound - _BOUND_TOL)
    if dist_threshold is not None:
        ok |= bound > dist_threshold + _BOUND_TOL
    row_ok = ~pos_valid | ok
    exact = row_ok.all() & tile_ok.all()
    return top_d, top_i, exact


def topk_neighbors_banded_or_dense(
    position: torch.Tensor,
    heading: torch.Tensor,
    k: int,
    angle_threshold: float,
    dense_fn: Callable[[], Tuple[torch.Tensor, torch.Tensor]],
    objects: Optional[torch.Tensor] = None,
    same_objects: bool = True,
    dist_threshold: Optional[float] = None,
    **kw,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Always-exact selector: the banded result when provably exact, else
    ``dense_fn()``.  The flag is read on the host (one sync per call);
    fallbacks are counted in ``KERNEL.fallbacks``."""
    bd, bi, exact = topk_neighbors_banded(
        position, heading, k, angle_threshold, objects=objects,
        same_objects=same_objects, dist_threshold=dist_threshold, **kw)
    if bool(exact):
        return bd, bi
    KERNEL.fallbacks += 1
    return dense_fn()

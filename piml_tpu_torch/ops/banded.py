"""K2: banded cell-list field-of-view top-k — O(N · window) per frame.

Replaces the Pallas kernels ``piml_tpu/ops/banded.py:116`` (``_kernel``)
and ``:128`` (``_kernel_dma``), which share ``_tile_compute``, with
``csrc/banded_topk.cu``.  The TPU split into a VMEM-resident and a DMA
variant existed only for VMEM capacity; here the cell-sorted table lives
in device memory and every row reads only its box's columns of its
tile's window, so one kernel covers both.

Host side (plain tensor code, as in the JAX package):

1. bin the objects into a static G×G grid and lay them out in cell order
   (:func:`build_object_index`);
2. sort the agents by their own cell, so a tile of 128 consecutive rows is
   spatially coherent and its 5×5 cell boxes lie in ONE contiguous window
   of the sorted table, starting at ``ws[tile] · 128``;
3. the kernel scores, for each row, only the columns of its 5×5 cell
   box that lie in its tile's window (:func:`box_ranges`: five column
   ranges of the cell-sorted table, one per box column, read from the
   table's cell offsets), with K1's distance and FOV math, keeping ties to
   the lowest ORIGINAL object id;
4. un-sort, then prove exactness: every row's k-th distance lies inside
   the unexamined-region bound (or the box covers the grid, or — with
   ``dist_threshold`` — the bound exceeds the threshold), and no tile's
   window overflowed.  :func:`topk_neighbors_banded_or_dense` reads that
   flag on the host once per frame and recomputes with the dense path
   when it is false.

:func:`topk_neighbors_banded_batched` runs C frames (the window channels
of the BPTT finetune) through ONE launch with a channel grid axis, as
``jax.vmap`` of the JAX selector batches its ``pallas_call``; steps 1, 2
and 4 run per channel on the host side.

Selection carries no gradient: the selectors and the plain version run
without autograd (the JAX package's ``lax.stop_gradient`` at the kernel
inputs), so gradients flow only through the neighbour states gathered
afterwards.

On the card the kernel's work is the in-box pairs (~66 a row for agents
at N = 12,685, against a window of ~1.8k columns): a block holds 32 rows
and five warps, one per box column, whose partial lists are merged at the
end (``csrc/banded_topk.cu``).
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
from piml_tpu_torch.utils.profiling import annotate

KERNEL = _build.KernelCount()
LANE = 128      # window starts are in units of LANE columns
TILE_N = 128    # agent rows per tile (one window start each)
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


@torch.no_grad()
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


@torch.no_grad()
def banded_topk_plain(ws: torch.Tensor, geo: torch.Tensor, rows: torch.Tensor,
                      cols: torch.Tensor, window: int, grid_dim: int, k: int,
                      cos_thr: float, self_pairs: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2: gather each tile's window, score every pair by
    direct differencing, then a stable sort on ``(d2, original id)``.

    Takes the kernel's layouts, with or without a leading channel axis
    (``rows (C, n_pad, 8)``, ``ws (C, T)``; ``geo`` / ``cols`` per channel
    or shared); channels are computed one after another."""
    if rows.ndim == 3:
        outs = [banded_topk_plain(ws[c], geo[c] if geo.ndim == 2 else geo,
                                  rows[c], cols[c] if cols.ndim == 3 else cols,
                                  window, grid_dim, k, cos_thr, self_pairs)
                for c in range(rows.shape[0])]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))
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


@torch.no_grad()
def box_ranges(ws: torch.Tensor, geo: torch.Tensor, rows: torch.Tensor,
               offsets: torch.Tensor, window: int, grid_dim: int
               ) -> torch.Tensor:
    """The column ranges the kernel walks, as it computes them: for each
    row and each cell column ``cx − 2 … cx + 2`` of its 5×5 box, the
    ``[start, end)`` of the sorted table's columns in that column's box
    cells (two entries of the table's cell ``offsets``), clipped to the
    row's tile window ``[ws·LANE, ws·LANE + window)``; ``(0, 0)`` for an
    invalid row or a cell column off the grid.  ``(…, n_pad, 5, 2)``
    int32, on the kernel's layouts with or without a channel axis.

    The table is sorted by cell id ``cx·G + cy`` with invalid and padding
    columns last, so the five ranges hold exactly the columns that
    :func:`banded_topk_plain` admits (window ∩ box ∩ valid), overflowed
    windows included.  Also the count of in-box pairs behind the kernel's
    bound."""
    g = grid_dim
    ax = cell_coords(rows[..., 0], geo[..., 0:1], geo[..., 2:3], g).long()
    ay = cell_coords(rows[..., 1], geo[..., 1:2], geo[..., 3:4], g).long()
    cx = ax[..., None] + torch.arange(-2, 3, device=rows.device)  # …, n, 5
    y0 = torch.clamp_min(ay - 2, 0)[..., None]
    y1 = torch.clamp_max(ay + 2, g - 1)[..., None]
    live = (cx >= 0) & (cx < g) & ~(rows[..., 4:5] < 0.5)
    cells = torch.stack([cx * g + y0, cx * g + y1 + 1], dim=-1)  # …, n, 5, 2
    cells = torch.where(live[..., None], cells, 0)
    if offsets.ndim == 1:           # one table (shared by the channels)
        ends = offsets[cells]
    else:                           # a table per channel
        ends = torch.gather(offsets, 1, cells.flatten(1)).view(cells.shape)
    start = (ws.long() * LANE).repeat_interleave(TILE_N, dim=-1)[..., None]
    end = start + window
    lo = torch.minimum(torch.maximum(ends[..., 0], start), end)
    hi = torch.minimum(torch.maximum(ends[..., 1], lo), end)
    return torch.where(live[..., None], torch.stack([lo, hi], dim=-1),
                       0).int()


def banded_topk_cuda(ws: torch.Tensor, geo: torch.Tensor, rows: torch.Tensor,
                     cols: torch.Tensor, window: int, grid_dim: int, k: int,
                     cos_thr: float, self_pairs: bool, offsets: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/banded_topk.cu`` on PyTorch's current stream.

    Single frame: ``rows (n_pad, 8)``, ``ws (T,)``, ``geo (4,)``,
    ``cols (6, m_band)``, ``offsets (G·G + 2,)`` → ``(n_pad, k)`` outputs.
    Channel-batched: ``rows (C, n_pad, 8)``, ``ws (C, T)``, ``geo (C, 4)``
    or shared ``(4,)``, ``cols (C, 6, m_band)`` and ``offsets
    (C, G·G + 2)``, or both shared → ``(C, n_pad, k)``; one launch with C
    blocks along its second grid axis.  ``offsets`` are the table's
    per-cell starts (:class:`ObjectIndex`); the kernel walks the
    :func:`box_ranges` they give."""
    batched = rows.ndim == 3
    chans = rows.shape[0] if batched else 1
    lead = rows.shape[:-2]
    n_pad = rows.shape[-2]
    mb = cols.shape[-1]
    for name, t, dt in (("ws", ws, torch.int32), ("geo", geo, torch.float32),
                        ("rows", rows, torch.float32),
                        ("cols", cols, torch.float32),
                        ("offsets", offsets, torch.int64)):
        if t.dtype != dt:
            raise TypeError(f"banded_topk: {name} must be {dt}")
        if not t.is_contiguous():
            raise ValueError(f"banded_topk: {name} must be contiguous")
        if t.device != rows.device:
            raise ValueError(f"banded_topk: {name} on {t.device}, "
                             f"rows on {rows.device}")
    geo_ok = geo.shape == (4,) or (batched and geo.shape == (chans, 4))
    cols_ok = cols.shape[-2:] == (6, mb) and (
        cols.ndim == 2 or (batched and cols.shape[0] == chans))
    offsets_ok = offsets.shape == cols.shape[:-2] + (
        grid_dim * grid_dim + 2,)
    if (n_pad % TILE_N or rows.shape[-1] != 8 or rows.ndim not in (2, 3)
            or not geo_ok or not cols_ok or not offsets_ok
            or ws.shape != lead + (n_pad // TILE_N,)):
        raise ValueError("banded_topk: bad shapes")
    if window <= 0 or mb < window + LANE:
        raise ValueError(f"banded_topk: window {window} vs table {mb}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"banded_topk: k={k} outside [1, {MAX_K}]")
    if not 1 <= chans <= 65535:
        raise ValueError(f"banded_topk: {chans} channels")
    if rows.device.type != "cuda":
        raise ValueError(f"banded_topk: the kernel needs CUDA tensors, "
                         f"got {rows.device}")
    lib = _build.LIBRARY.get()
    out_d = torch.empty(lead + (n_pad, k), dtype=torch.float32,
                        device=rows.device)
    out_i = torch.empty(lead + (n_pad, k), dtype=torch.int32,
                        device=rows.device)
    status = lib.piml_banded_topk(
        ws.data_ptr(), geo.data_ptr(), 4 if geo.ndim == 2 else 0,
        rows.data_ptr(), n_pad, chans, cols.data_ptr(), mb,
        6 * mb if cols.ndim == 3 else 0, offsets.data_ptr(),
        offsets.shape[-1] if offsets.ndim == 2 else 0, window, grid_dim,
        cos_thr, int(self_pairs), k, out_d.data_ptr(), out_i.data_ptr(),
        _build.stream_handle(rows.device))
    _build.check(status, "piml_banded_topk")
    KERNEL.launches += 1
    return out_d, out_i


def banded_topk(ws, geo, rows, cols, window, grid_dim, k, cos_thr,
                self_pairs, offsets):
    """K2 on packed inputs, with or without a leading channel axis: the
    plain version for a CPU tensor (which needs no ``offsets``), the
    kernel for a CUDA tensor (which raises rather than fall back)."""
    if rows.device.type == "cpu":
        return banded_topk_plain(ws, geo, rows, cols, window, grid_dim, k,
                                 cos_thr, self_pairs)
    return banded_topk_cuda(ws, geo, rows, cols, window, grid_dim, k,
                            cos_thr, self_pairs, offsets)


class _Sorted(NamedTuple):
    """One frame's agents in the object grid's cell order, tiled."""

    ws: torch.Tensor        # (T,) window starts in LANE units
    rows: torch.Tensor      # (n_pad, 8) packed, cell-sorted agent rows
    inv: torch.Tensor       # (N,) un-sort permutation
    pos: torch.Tensor       # (N, 2) positions, absent → 0
    pos_valid: torch.Tensor
    acell: torch.Tensor     # (N, 2) agent cells, absent pinned to G − 1
    tile_ok: torch.Tensor   # (T,) window held the tile's 5×5 boxes


def _sort_into_tiles(position, heading, index: ObjectIndex, g: int,
                     window: int, same_objects: bool,
                     agent_order, self_ids=None) -> _Sorted:
    n = position.shape[0]
    rows_unsorted = pack_rows(position, heading, self_ids)
    pos = rows_unsorted[:, 0:2]
    pos_valid = rows_unsorted[:, 4] > 0.5
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
    return _Sorted(win_start_lanes.int(), rows, inv, pos, pos_valid, acell,
                   tile_ok)


def _exact(srt: _Sorted, top_d: torch.Tensor, index: ObjectIndex, g: int,
           k_eff: int, dist_threshold: Optional[float]) -> torch.Tensor:
    """The exactness predicate (grid_pairs' box semantics): every valid
    row's k-th distance lies inside the unexamined-region bound, or its box
    covers the grid, or (with ``dist_threshold``) the bound exceeds the
    threshold; and no tile's window overflowed."""
    lo, cs, pos = index.lo, index.cs, srt.pos
    ax, ay = srt.acell[:, 0], srt.acell[:, 1]
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
    row_ok = ~srt.pos_valid | ok
    return row_ok.all() & srt.tile_ok.all()


@torch.no_grad()
def _banded(position, heading, k_eff: int, angle_threshold: float,
            same_objects: bool, g: int, window: int,
            dist_threshold: Optional[float], indexes, agent_orders,
            self_ids=None):
    """Shared body of both selectors over ``(C, N, 2)`` frames: the
    host-side sort per channel, ONE kernel launch for all channels, then
    the un-sort and the exactness predicate per channel.  ``self_ids``
    (single frame only): the rows' ids in the object table's id space."""
    chans = position.shape[0]
    srts = [_sort_into_tiles(position[c], heading[c], indexes[c], g, window,
                             same_objects, agent_orders[c], self_ids)
            for c in range(chans)]
    shared = all(ix is indexes[0] for ix in indexes)

    def geo_of(ix):
        return torch.stack([ix.lo[0], ix.lo[1], ix.cs[0], ix.cs[1]])

    if shared:
        geo, cols = geo_of(indexes[0]).contiguous(), indexes[0].cols
        offsets = indexes[0].offsets
    else:
        geo = torch.stack([geo_of(ix) for ix in indexes])
        cols = torch.stack([ix.cols for ix in indexes])
        offsets = torch.stack([ix.offsets for ix in indexes])
    out_d, out_i = banded_topk(
        torch.stack([s_.ws for s_ in srts]), geo,
        torch.stack([s_.rows for s_ in srts]), cols, window, g, k_eff,
        cos_threshold(angle_threshold),
        same_objects or self_ids is not None, offsets)
    n = position.shape[1]
    top_d = torch.stack([out_d[c, :n][s_.inv] for c, s_ in enumerate(srts)])
    top_i = torch.stack([out_i[c, :n][s_.inv] for c, s_ in enumerate(srts)])
    exact = torch.stack([
        _exact(s_, top_d[c], indexes[c], g, k_eff, dist_threshold)
        for c, s_ in enumerate(srts)])
    return top_d, top_i, exact


def _check_index(index: ObjectIndex, m: int, g: int, window: int) -> None:
    if (index.cols.shape[-1] != m_band(m, window)
            or index.offsets.shape[0] != g * g + 2):
        raise ValueError(
            f"prebuilt ObjectIndex does not match banded params "
            f"(grid_dim={g}, window={window}); build it with "
            f"build_object_index(objects, *banded_params(...))")


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
    self_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Banded FOV top-k: ``(dist (N, k'), idx (N, k'), exact ())``.

    Same contract as ``topk_neighbors_pallas`` plus the device-side
    ``exact`` flag.  ``index``: a prebuilt :func:`build_object_index` for a
    static object table (``objects`` then only gives its shape).
    ``agent_order``: a precomputed ``(order, inverse)`` agent sort shared
    between the passes of one frame.  ``self_ids``: each query's id in the
    object table (the queries are a shard of it, as in
    ``parallel/agent_shard.py``), so that its self pair gets the dense
    kernel's pinned ``(d2, rel_h) = (0, 0)`` although ``same_objects`` is
    False (piml_tpu/ops/banded.py:385).
    """
    if objects is None:
        objects = position
        same_objects = True
    n, m = position.shape[0], objects.shape[0]
    g, window = banded_params(n, m, k, grid_dim, window,
                              fine=dist_threshold is not None)
    if index is None:
        index = build_object_index(objects, g, window)
    _check_index(index, m, g, window)
    d, i, ex = _banded(position[None], heading[None],
                       min(k, m), angle_threshold, same_objects, g, window,
                       dist_threshold, [index], [agent_order], self_ids)
    return d[0], i[0], ex[0]


def topk_neighbors_banded_batched(
    position: torch.Tensor,
    heading: torch.Tensor,
    k: int,
    angle_threshold: float,
    objects: Optional[torch.Tensor] = None,
    grid_dim: Optional[int] = None,
    window: Optional[int] = None,
    dist_threshold: Optional[float] = None,
    index: Optional[ObjectIndex] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`topk_neighbors_banded` over C frames ``(C, N, 2)`` in one
    launch: ``(dist (C, N, k'), idx (C, N, k'), exact (C,))``.

    ``objects=None``: each channel selects among its own agents (one cell
    index per channel); else the static ``(M, 2)`` table (or its prebuilt
    ``index``) is shared by all channels.  Equal, channel for channel, to
    single-frame calls without ``agent_order`` (``jax.vmap`` of the JAX
    selector)."""
    chans, n = position.shape[0], position.shape[1]
    same_objects = objects is None
    m = n if same_objects else objects.shape[0]
    g, window = banded_params(n, m, k, grid_dim, window,
                              fine=dist_threshold is not None)
    if same_objects:
        indexes = [build_object_index(position[c], g, window)
                   for c in range(chans)]
    else:
        if index is None:
            index = build_object_index(objects, g, window)
        _check_index(index, m, g, window)
        indexes = [index] * chans
    return _banded(position, heading, min(k, m), angle_threshold,
                   same_objects, g, window, dist_threshold, indexes,
                   [None] * chans)


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
    with annotate("sync.k2_exact"):
        exact = bool(exact)
    if exact:
        return bd, bi
    KERNEL.fallbacks += 1
    return dense_fn()


def topk_neighbors_banded_batched_or_dense(
    position: torch.Tensor,
    heading: torch.Tensor,
    k: int,
    angle_threshold: float,
    dense_fn: Callable[[], Tuple[torch.Tensor, torch.Tensor]],
    **kw,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Always-exact channel-batched selector: the banded result when every
    channel is provably exact, else ``dense_fn()`` for the whole batch —
    the JAX package's ``lax.cond(jnp.all(exact), ...)``.  One host read
    per call; fallbacks are counted in ``KERNEL.fallbacks``."""
    bd, bi, exact = topk_neighbors_banded_batched(
        position, heading, k, angle_threshold, **kw)
    with annotate("sync.k2_exact"):
        exact = bool(exact.all())
    if exact:
        return bd, bi
    KERNEL.fallbacks += 1
    return dense_fn()

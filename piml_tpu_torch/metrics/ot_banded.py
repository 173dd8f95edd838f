"""Banded (cell-list) Sinkhorn for dense-N crowds.

Counterpart of ``piml_tpu/metrics/ot_banded.py``.  At ε = 0.1 a pair at
distance d weighs exp(-d²/ε) against its row's near neighbours, so beyond a
few metres its terms vanish below float32's range.  The banded Sinkhorn
runs the reference's update sequence on a cell-banded candidate structure
(both clouds cell-sorted on one shared grid; each 128-query tile reads one
contiguous window of the other cloud's sorted table) and proves, at every
iteration, that each excluded term is ≤ 1e-12 of its row's logsumexp.
When the proof holds the cost equals the dense kernel's to float32
rounding; when it fails (clouds too spread, potentials too wild, a window
truncated), :func:`sinkhorn_banded_or_dense` takes the streaming dense
kernel instead.

The proof is a device tensor ANDed over the iterations and read on the
host once per frame, where the JAX package's ``lax.cond`` reads it.  The
grid, the sort, the windows and the bounds are torch ops, taken once a
frame; the iteration is :func:`banded_iterations_plain` (torch ops over the
windows' pair tensors) for CPU tensors and ``ops/sinkhorn.py``
``banded_iterations_cuda`` (a hand-written kernel, no pair tensor) for
CUDA tensors.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from piml_tpu_torch.metrics.metrics import (_STOP_CHECK, NEG_BIG, _finite,
                                            sinkhorn_masked_chunked)
from piml_tpu_torch.ops import sinkhorn
from piml_tpu_torch.ops.sinkhorn import LANE, BandedSide

# excluded-mass tolerance: per-row neglected weight ≤ e^LOG_TOL of the
# row's included logsumexp
LOG_TOL = math.log(1e-12)


def _round_up(v: int, mult: int) -> int:
    return -(-v // mult) * mult


def ot_banded_params(n: int, m: int, grid_dim: Optional[int] = None,
                     window: Optional[int] = None) -> Tuple[int, int]:
    """(grid_dim, window) for a banded Sinkhorn at these cloud sizes:
    ~1 point per cell, and a window covering a tile's x-cell-row span plus
    the ±2-row margin with 40 % slack.  An undersized window only fails
    the coverage check (→ dense fallback), never the value."""
    if grid_dim is None:
        grid_dim = int(max(16, min(256, round(math.sqrt(max(n, m, 1))))))
    if window is None:
        per_row = max(m / grid_dim, 1.0)
        span = max(1, math.ceil(LANE / per_row))
        window = _round_up(int((span + 5) * per_row * 1.4) + LANE, LANE)
        window = min(window, _round_up(max(m, LANE), LANE))
    return grid_dim, window


def _shared_grid(x, y, valid_x, valid_y, g: int):
    """Quantile-robust grid bounds over the union of both clouds."""
    pts = torch.cat([x, y], dim=0)
    valid = torch.cat([valid_x, valid_y], dim=0)
    masked = torch.where(valid[:, None], pts, math.nan)
    qs = torch.nanquantile(
        masked, torch.tensor([0.005, 0.995], device=x.device), dim=0)
    lo, hi = qs[0], qs[1]
    empty = ~valid.any()
    lo = torch.where(empty | torch.isnan(lo), 0.0, lo)
    hi = torch.where(empty | torch.isnan(hi), 1.0, hi)
    cs = torch.clamp_min((hi - lo) / g, 1e-6)
    return lo, cs


def _sorted_cloud(pts, valid, lo, cs, g: int, n_pad: int):
    """Cell-sort a cloud on the shared grid.

    Returns (order, offsets, pos_sorted (n_pad, 2), valid_sorted (n_pad,),
    cellx_sorted (n_pad,)): invalid rows sort last (cell id g²); padding
    repeats the last row with valid = 0 so it never stretches windows."""
    n = pts.shape[0]
    dev = pts.device
    p0 = torch.where(valid[:, None], pts, 0.0)
    cc = torch.clamp(torch.floor((p0 - lo) / cs), 0, g - 1).long()
    cid = torch.where(valid, cc[:, 0] * g + cc[:, 1], g * g)
    order = torch.argsort(cid, stable=True)
    counts = torch.bincount(cid, minlength=g * g + 1)
    offsets = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                         torch.cumsum(counts, 0)])
    idx = torch.cat([order, order[-1:].expand(n_pad - n)])
    comp = torch.cat([p0, valid[:, None].to(p0.dtype)], dim=1)[idx]
    pos_s = comp[:, :2].contiguous()
    valid_s = comp[:, 2] * (torch.arange(n_pad, device=dev) < n)
    cellx_s = torch.clamp(torch.floor((pos_s[:, 0] - lo[0]) / cs[0]),
                          0, g - 1).long()
    cellx_s = torch.where(valid_s > 0.5, cellx_s, g - 1)
    return order, offsets, pos_s, valid_s, cellx_s


def _side_windows(qpos, qcellx, t_offsets, lo, cs, g: int, window: int):
    """Per-tile windows of one side's queries into the other's sorted table.

    Returns (start lanes (T,), window ends (T,): the end of each window's
    true span, bound² (n_pad,): the distance² every window-excluded point
    provably exceeds (inf when nothing is excluded), tiles_ok ())."""
    num_tiles = qpos.shape[0] // LANE
    cx_t = qcellx.reshape(num_tiles, LANE)
    cx0 = torch.clamp(cx_t.amin(dim=1) - 2, 0, g - 1)
    cx1 = torch.clamp(cx_t.amax(dim=1) + 2, 0, g - 1)
    start_lanes = t_offsets[cx0 * g] // LANE                  # (T,)
    win_end = t_offsets[(cx1 + 1) * g]
    tiles_ok = ((win_end - start_lanes * LANE) <= window).all()

    # distance any point outside the ±2 x-cell-row band exceeds
    bx_lo = lo[0] + (qcellx - 2).to(qpos.dtype) * cs[0]
    bx_hi = lo[0] + (qcellx + 3).to(qpos.dtype) * cs[0]
    d_left = torch.where(qcellx - 2 > 0, qpos[:, 0] - bx_lo, math.inf)
    d_right = torch.where(qcellx + 2 < g - 1, bx_hi - qpos[:, 0], math.inf)
    bound = torch.clamp_min(torch.minimum(d_left, d_right), 0.0)
    return start_lanes, win_end, bound ** 2, tiles_ok


def _side(pos, valid, log_marg, bound2, other_valid, start_lanes, win_end):
    """One side's rows as the iteration reads them (``BandedSide``)."""
    fin = torch.isfinite(bound2)
    trivially_ok = (valid < 0.5) | ~fin | ~(other_valid > 0.5).any()
    consts = torch.stack([log_marg, -bound2,
                          torch.log1p(torch.where(fin, bound2, 0.0)),
                          trivially_ok.to(pos.dtype)], dim=1)
    return BandedSide(pos, valid, consts, start_lanes, win_end)


def _window_terms(q: BandedSide, t: BandedSide, window: int, inv_eps: float):
    """The plain iteration's window tensors of side ``q``'s tiles in side
    ``t``'s table: (A (T, 128, W) = -d²/ε, tvalid_win (T, W), block ids
    (T, W/LANE))."""
    dev = q.pos.device
    num_tiles = q.rows // LANE
    w_blocks = window // LANE
    m_pad = t.rows
    bids = (q.start[:, None]
            + torch.arange(w_blocks, device=dev)[None, :])
    bids = torch.clamp_max(bids, m_pad // LANE - 1)           # (T, w_blocks)
    tx = t.pos[:, 0].reshape(-1, LANE)[bids]
    ty = t.pos[:, 1].reshape(-1, LANE)[bids]
    tv = t.valid.reshape(-1, LANE)[bids]
    # windows may overrun the padded table's tail (clamped block ids repeat
    # the last block): drop duplicates beyond the true window end
    flat_pos = (bids[..., None] * LANE
                + torch.arange(LANE, device=dev)).reshape(num_tiles, window)
    in_win = flat_pos < q.win_end[:, None]
    seq = q.start[:, None] * LANE + torch.arange(window, device=dev)
    in_win &= flat_pos == seq                                  # monotone span
    tx = tx.reshape(num_tiles, window)
    ty = ty.reshape(num_tiles, window)
    tvalid_win = torch.where(in_win, tv.reshape(num_tiles, window), 0.0)

    qx = q.pos[:, 0].reshape(num_tiles, LANE, 1)
    qy = q.pos[:, 1].reshape(num_tiles, LANE, 1)
    d2 = (tx[:, None, :] - qx) ** 2 + (ty[:, None, :] - qy) ** 2
    A = -d2 * inv_eps                                         # (T, 128, W)
    return A, tvalid_win, bids


def banded_iterations_plain(x: BandedSide, y: BandedSide, window: int,
                            eps: float, max_iter: int, thresh: float,
                            log_m_terms: torch.Tensor, exact: torch.Tensor,
                            log_tol: float, stop_check: int
                            ) -> Tuple[torch.Tensor, ...]:
    """Plain version of ``ops/sinkhorn.py`` ``banded_iterations_cuda``: the
    reference's iteration from zero potentials on the windows' pair
    tensors, then the transport cost.  Returns ``(cost, exact,
    iterations)``."""
    dev = x.pos.device
    inv_eps = 1.0 / eps
    A_x, yv_win, ybids = _window_terms(x, y, window, inv_eps)
    A_y, xv_win, xbids = _window_terms(y, x, window, inv_eps)
    xval, yval = x.valid, y.valid

    Tq = x.rows // LANE
    # loop-invariant parts of the half-updates
    pv_x = (yv_win[:, None, :] > 0.5) & (xval.reshape(-1, LANE)[:, :, None]
                                         > 0.5)
    pv_y = (xv_win[:, None, :] > 0.5) & (yval.reshape(-1, LANE)[:, :, None]
                                         > 0.5)

    def half_update(A, pv, bids, other_pot, other_valid, q):
        """One reference half-update on a banded side: the new potential
        (flat, sorted order) and this pass's exactness proof."""
        log_marg, neg_bound2, log1p_b2 = (q.consts[:, 0], q.consts[:, 1],
                                          q.consts[:, 2])
        trivially_ok = q.consts[:, 3] > 0.5
        pot_win = other_pot.reshape(-1, LANE)[bids].reshape(A.shape[0], -1)
        M = torch.where(pv, A + pot_win[:, None, :] * inv_eps, NEG_BIG)
        ls = torch.logsumexp(M, dim=-1).reshape(-1)              # (n_pad,)
        new = eps * (log_marg - ls)
        new = torch.where(q.valid > 0.5, new, 0.0)
        # proof: every window-excluded term ≤ e^log_tol of the row lse; the
        # log1p(bound²) term extends it to the cost-weighted tail of the
        # final value pass (C·e^{-C/ε} decreases beyond C = ε ≤ bound²)
        wmax = torch.where(other_valid > 0.5, other_pot, -math.inf).max()
        margin = ((neg_bound2 + wmax) * inv_eps + log_m_terms + log1p_b2
                  - ls)
        row_ok = trivially_ok | (margin <= log_tol)
        return new, row_ok.all()

    u = torch.zeros(x.rows, device=dev)
    v = torch.zeros(y.rows, device=dev)
    err = torch.full((), math.inf, device=dev)
    iterations = torch.zeros((), dtype=torch.long, device=dev)
    for it in range(max_iter):
        active = err >= thresh
        if it % stop_check == 0 and not bool(active):
            break
        iterations = iterations + active
        u1 = u
        un, ok_u = half_update(A_x, pv_x, ybids, v, yval, x)
        vn, ok_v = half_update(A_y, pv_y, xbids, un, xval, y)
        errn = ((un - u1) * xval).abs().sum()
        u = torch.where(active, un, u)
        v = torch.where(active, vn, v)
        err = torch.where(active, errn, err)
        exact = exact & (ok_u & ok_v | ~active)

    # transport cost on the included pairs (the excluded mass is covered by
    # the per-iteration proof)
    v_win = v.reshape(-1, LANE)[ybids].reshape(Tq, -1)
    M = torch.where(pv_x,
                    A_x + (u.reshape(Tq, LANE)[:, :, None]
                           + v_win[:, None, :]) * inv_eps,
                    NEG_BIG)
    C = -A_x * eps
    cost = torch.where(pv_x, torch.exp(M) * C, 0.0).sum()
    return cost, exact, iterations


def sinkhorn_banded(x: torch.Tensor, y: torch.Tensor, mask_x: torch.Tensor,
                    mask_y: torch.Tensor, eps: float = 0.1,
                    max_iter: int = 100, thresh: float = 1e-1,
                    grid_dim: Optional[int] = None,
                    window: Optional[int] = None,
                    with_iterations: bool = False) -> Tuple[torch.Tensor, ...]:
    """The reference's Sinkhorn iteration on the banded structure, one
    frame.  Returns ``(cost, exact)``, both device tensors: when ``exact``
    is True the cost equals :func:`sinkhorn_masked_chunked`'s on the same
    inputs to float32 rounding; when False the cost is untrusted.
    ``with_iterations`` appends the number of iterations the frame ran
    (a device tensor)."""
    n, m = x.shape[0], y.shape[0]
    dev = x.device
    g, w = ot_banded_params(n, m, grid_dim, window)

    x, y = _finite(x), _finite(y)
    valid_x = mask_x > 0.5
    valid_y = mask_y > 0.5
    nx = torch.clamp_min(mask_x.sum(), 1.0)
    ny = torch.clamp_min(mask_y.sum(), 1.0)

    lo, cs = _shared_grid(x, y, valid_x, valid_y, g)
    n_pad = _round_up(max(n, LANE), LANE)
    m_pad = _round_up(max(m, LANE), LANE)
    xord, xoff, xpos, xval, xcellx = _sorted_cloud(x, valid_x, lo, cs, g,
                                                   n_pad)
    yord, yoff, ypos, yval, ycellx = _sorted_cloud(y, valid_y, lo, cs, g,
                                                   m_pad)

    # marginal logs in sorted order (reference: log(mu + 1e-8))
    log_floor = torch.log(torch.tensor(1e-8, device=dev))

    def sorted_log_marginal(mask, count, order, pad):
        zeros = torch.zeros(pad, dtype=order.dtype, device=dev)
        return torch.log(torch.nn.functional.pad(mask / count, (0, pad))[
            torch.cat([order, zeros])] + 1e-8)

    log_mu = torch.where(xval > 0.5,
                         sorted_log_marginal(mask_x, nx, xord, n_pad - n),
                         log_floor)
    log_nu = torch.where(yval > 0.5,
                         sorted_log_marginal(mask_y, ny, yord, m_pad - m),
                         log_floor)

    xstart, xend, xbound2, ok_x = _side_windows(xpos, xcellx, yoff, lo, cs,
                                                g, w)
    ystart, yend, ybound2, ok_y = _side_windows(ypos, ycellx, xoff, lo, cs,
                                                g, w)
    sx = _side(xpos, xval, log_mu, xbound2, yval, xstart, xend)
    sy = _side(ypos, yval, log_nu, ybound2, xval, ystart, yend)
    log_m_terms = torch.log(torch.clamp_min(torch.maximum(nx, ny), 2.0))
    iterate = (banded_iterations_plain if dev.type == "cpu"
               else sinkhorn.banded_iterations_cuda)
    cost, exact, iterations = iterate(sx, sy, w, eps, max_iter, thresh,
                                      log_m_terms, ok_x & ok_y, LOG_TOL,
                                      _STOP_CHECK)
    return (cost, exact, iterations) if with_iterations else (cost, exact)


def sinkhorn_banded_or_dense(x: torch.Tensor, y: torch.Tensor,
                             mask_x: torch.Tensor, mask_y: torch.Tensor,
                             eps: float = 0.1, max_iter: int = 100,
                             thresh: float = 1e-1, block: int = 2048
                             ) -> torch.Tensor:
    """Banded Sinkhorn with its proof; the streaming dense kernel when the
    proof fails (one host read of ``exact``; counted in
    ``ops.sinkhorn.KERNEL.fallbacks``)."""
    cost, exact = sinkhorn_banded(x, y, mask_x, mask_y, eps=eps,
                                  max_iter=max_iter, thresh=thresh)
    if bool(exact):
        return cost
    sinkhorn.KERNEL.fallbacks += 1
    return sinkhorn_masked_chunked(x, y, mask_x, mask_y, eps=eps,
                                   max_iter=max_iter, thresh=thresh,
                                   block=block)

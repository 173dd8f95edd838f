"""Agent-sharded evaluation metrics: Sinkhorn OT and multi-kernel MMD.

Counterpart of ``piml_tpu/parallel/metrics_shard.py`` (reference
semantics: src/functions/metrics.py:107-273).  The point clouds are small
and every rank holds them whole; the O(N·M) row blocks of each potential
update and kernel tile split over the mesh axis (each rank owns its
query rows), and the scalar reductions (the convergence error, the
transport cost, the MMD quadrant sums) are all-reduced.  Every function
takes the same full inputs on every rank and returns the same scalar on
every rank; N need not divide the ranks (padded rows carry no mass).

Each rank sums its row block in the order the single-device kernels sum
that slice, so results agree with them to float32 reduction order.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.device_mesh import DeviceMesh

from piml_tpu_torch.parallel import distributed as pd
from piml_tpu_torch.parallel.sharding import axis_group, axis_rank, axis_size

__all__ = ["sharded_sinkhorn", "sharded_mmd", "sharded_ot_with_time_mask",
           "sharded_mmd_with_time_mask"]

_NEG_BIG = -1e9


def _pad_rows(a: torch.Tensor, mult: int) -> torch.Tensor:
    """Zero rows up to a multiple of ``mult`` (zero masks: no mass)."""
    pad = -a.shape[0] % mult
    if pad:
        a = torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
    return a


def _finite(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, 0.0)


def _rows(a: torch.Tensor, rank: int, n_dev: int) -> torch.Tensor:
    m = a.shape[0] // n_dev
    return a[rank * m:(rank + 1) * m]


def _sinkhorn_tiles(x_t, mx_t, u_t, y, my, v, eps):
    """One ``(rows_local, M)`` block of M(u, v) and its cost block: the
    arithmetic of ``metrics.sinkhorn_masked_chunked``'s tiles."""
    dx = x_t[:, 0][:, None] - y[:, 0][None, :]
    dy = x_t[:, 1][:, None] - y[:, 1][None, :]
    c = dx * dx + dy * dy
    m = (-c + u_t[:, None] + v[None, :]) / eps
    return torch.where((mx_t[:, None] * my[None, :]) == 1, m, _NEG_BIG), c


@torch.no_grad()
def sharded_sinkhorn(x: torch.Tensor, y: torch.Tensor, mask_x: torch.Tensor,
                     mask_y: torch.Tensor, mesh: DeviceMesh,
                     axis: str = "ap", eps: float = 0.1, max_iter: int = 100,
                     thresh: float = 1e-1, with_iterations: bool = False):
    """Entropic OT with the pair-matrix row blocks sharded over the mesh
    axis: the reference's update sequence (metrics.py:107-203).  ``u``'s
    rows live where ``x``'s do, ``v``'s where ``y``'s do; each half-update
    all-gathers the opposite potential and recomputes the rank's cost
    block.  The convergence error is all-reduced, so every rank leaves the
    loop on the same iteration.  ``with_iterations``: also return their
    count."""
    group = axis_group(mesh, axis)
    n_dev, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    x = _pad_rows(_finite(x), n_dev)
    y = _pad_rows(_finite(y), n_dev)
    mask_x = _pad_rows(mask_x, n_dev)
    mask_y = _pad_rows(mask_y, n_dev)
    nx = torch.clamp_min(mask_x.sum(), 1.0)
    ny = torch.clamp_min(mask_y.sum(), 1.0)
    log_mu = torch.log(mask_x / nx + 1e-8)
    log_nu = torch.log(mask_y / ny + 1e-8)
    x_t, mx_t, lmu_t = (_rows(a, r, n_dev) for a in (x, mask_x, log_mu))
    y_t, my_t, lnu_t = (_rows(a, r, n_dev) for a in (y, mask_y, log_nu))

    u_t = torch.zeros_like(mx_t)
    v_t = torch.zeros_like(my_t)
    err, it = math.inf, 0
    while err >= thresh and it < max_iter:
        u1 = u_t
        v_full = pd.all_gather(v_t, group)
        blk, _ = _sinkhorn_tiles(x_t, mx_t, u_t, y, mask_y, v_full, eps)
        u_t = eps * (lmu_t - torch.logsumexp(blk, dim=-1)) + u_t
        u_full = pd.all_gather(u_t, group)
        # the v-update's rows are the transposed block's: the local y rows
        blk, _ = _sinkhorn_tiles(y_t, my_t, v_t, x, mask_x, u_full, eps)
        v_t = eps * (lnu_t - torch.logsumexp(blk, dim=-1)) + v_t
        err = float(pd.all_reduce(((u_t - u1) * mx_t).abs().sum(), group))
        it += 1

    v_full = pd.all_gather(v_t, group)
    m_blk, c_blk = _sinkhorn_tiles(x_t, mx_t, u_t, y, mask_y, v_full, eps)
    pi = torch.exp(m_blk) * (mx_t[:, None] * mask_y[None, :])
    cost = pd.all_reduce((pi * c_blk).sum(), group)
    return (cost, it) if with_iterations else cost


@torch.no_grad()
def sharded_mmd(source: torch.Tensor, target: torch.Tensor,
                mask_s: torch.Tensor, mask_t: torch.Tensor, mesh: DeviceMesh,
                axis: str = "ap", kernel_mul: float = 2.0,
                kernel_num: int = 5) -> torch.Tensor:
    """Multi-kernel Gaussian MMD with the kernel-matrix row blocks sharded:
    the math of ``metrics.mmd_masked_chunked`` (the O(N) closed-form
    bandwidth, power-of-two kernel scales as squarings, quadrant sums as
    matrix-vector products); the four quadrant sums are all-reduced."""
    group = axis_group(mesh, axis)
    n_dev, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    total = torch.cat([_finite(source), _finite(target)])
    mask = torch.cat([mask_s, mask_t])
    is_s = torch.cat([mask_s, torch.zeros_like(mask_t)])
    is_t = torch.cat([torch.zeros_like(mask_s), mask_t])

    # the closed-form bandwidth: the pair-distance sum of mean-centred
    # points, O(N) on every rank
    n_samples = torch.clamp_min(mask.sum(), 2.0)
    center = (total * mask[:, None]).sum(dim=0) / n_samples
    tc = (total - center) * mask[:, None]
    sq = (tc ** 2).sum()
    l2_sum = 2.0 * (n_samples * sq - (tc.sum(dim=0) ** 2).sum())
    bandwidth = l2_sum / (n_samples ** 2 - n_samples)
    bandwidth = bandwidth / (kernel_mul ** (kernel_num // 2))
    bw = torch.clamp_min(bandwidth, 1e-12)

    total, mask, is_s, is_t = (_pad_rows(a, n_dev)
                               for a in (total, mask, is_s, is_t))
    rows_t, mrow_t, ss_t, tt_t = (_rows(a, r, n_dev)
                                  for a in (total, mask, is_s, is_t))
    dx = rows_t[:, 0][:, None] - total[:, 0][None, :]
    dy = rows_t[:, 1][:, None] - total[:, 1][None, :]
    pair = mrow_t[:, None] * mask[None, :]
    d = (dx * dx + dy * dy) * pair
    if float(kernel_mul) == 2.0:
        e = torch.exp(-d / (bw * kernel_mul ** (kernel_num - 1)))
        k = e
        for _ in range(kernel_num - 1):
            e = e * e
            k = k + e
    else:
        k = torch.zeros_like(d)
        for i in range(kernel_num):
            k = k + torch.exp(-d / (bw * kernel_mul ** i))
    k = k * pair
    ks = k @ is_s
    kt = k @ is_t
    quad = pd.all_reduce(torch.stack([(ss_t * ks).sum(), (tt_t * kt).sum(),
                                      (ss_t * kt).sum(), (tt_t * ks).sum()]),
                         group)
    ns = torch.clamp_min(mask_s.sum(), 1.0)
    nt = torch.clamp_min(mask_t.sum(), 1.0)
    return (quad[0] / (ns * ns) + quad[1] / (nt * nt)
            - quad[2] / (ns * nt) - quad[3] / (nt * ns))


def _per_frame(metric, p, q, mask, mesh, axis, mode):
    """The reference's frame loop (metrics.py:45-91): frames with ≤ 1
    present agent count 0 (and are skipped: the mask is the same on every
    rank, so every rank skips alike)."""
    m = (mask == 1).to(p.dtype)
    active = (mask == 1).sum(dim=-1) > 1
    per_frame = torch.zeros(mask.shape[0], dtype=p.dtype, device=p.device)
    for t in torch.nonzero(active).flatten().tolist():
        per_frame[t] = metric(p[t], q[t], m[t], m[t], mesh, axis)
    if mode == "sum":
        return per_frame.sum()
    return per_frame.sum() / torch.clamp_min(active.sum(), 1)


def sharded_ot_with_time_mask(p: torch.Tensor, q: torch.Tensor,
                              mask: torch.Tensor, mesh: DeviceMesh,
                              axis: str = "ap",
                              mode: str = "mean") -> torch.Tensor:
    """Per-frame :func:`sharded_sinkhorn` (``ot_with_time_mask``'s
    semantics): ``p``, ``q`` ``(T, N, 2)``, ``mask`` ``(T, N)``."""
    return _per_frame(sharded_sinkhorn, p, q, mask, mesh, axis, mode)


def sharded_mmd_with_time_mask(p: torch.Tensor, q: torch.Tensor,
                               mask: torch.Tensor, mesh: DeviceMesh,
                               axis: str = "ap",
                               mode: str = "mean") -> torch.Tensor:
    """Per-frame :func:`sharded_mmd` (``mmd_with_time_mask``'s semantics;
    leading axes beyond one fold into the frame axis)."""
    if mask.ndim > 2:
        mask = mask.reshape(-1, mask.shape[-1])
        p = p.reshape(mask.shape[0], p.shape[-2], p.shape[-1])
        q = q.reshape(mask.shape[0], q.shape[-2], q.shape[-1])
    return _per_frame(sharded_mmd, p, q, mask, mesh, axis, mode)

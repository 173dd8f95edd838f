"""Evaluation metrics: masked displacement error, Sinkhorn OT, multi-kernel
MMD and collision counts.

Counterpart of ``piml_tpu/metrics/metrics.py`` (reference:
src/functions/metrics.py).  The JAX package vmaps a ``lax.while_loop`` over
frames, so each frame stops iterating on its own; here a batch of frames
iterates together and a device-side ``active`` mask freezes every frame
from the iteration at which it converged, which gives each frame exactly
the iterations JAX gives it.  The stop flag is read on the host every
``_STOP_CHECK`` iterations only: frozen frames do not change, so reading
it late changes no value.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from piml_tpu_torch.physics import collision_detection
from piml_tpu_torch.utils.profiling import annotate

# host reads of the "every frame converged" flag, one per this many
# Sinkhorn iterations
_STOP_CHECK = 8
# per-temporary element budget of the frame-batched dense OT / MMD: a
# 750-frame scene at N = 2,048 would otherwise allocate (T, N, N) f32
# temporaries of ~12 GB each
_BATCH_ELEMS = 2 ** 26
NEG_BIG = -1e9


def collision_count(position: torch.Tensor, threshold: float,
                    real_position: Optional[torch.Tensor] = None,
                    mode: str = "sum") -> torch.Tensor:
    """Contact count with friends filtering (reference: metrics.py:16-26)."""
    coll = collision_detection(position, threshold, real_position)
    if mode == "sum":
        return coll.sum()
    if mode == "mean":
        return coll.mean()
    return coll


def mae_with_time_mask(p: torch.Tensor, q: torch.Tensor, mask: torch.Tensor,
                       mode: str = "mean") -> torch.Tensor:
    """Masked mean/sum of per-agent L2 displacement error
    (reference: metrics.py:29-42)."""
    err = torch.linalg.vector_norm(
        torch.where(mask[..., None] == 1, p - q, 0.0), dim=-1)
    total = err.sum()
    if mode == "sum":
        return total
    return total / torch.clamp_min((mask == 1).sum(), 1)


def _finite(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, 0.0)


def _frame_chunk(per_frame_elems: int) -> int:
    return max(1, _BATCH_ELEMS // max(per_frame_elems, 1))


# ---------------------------------------------------------------------------
# Sinkhorn OT
# ---------------------------------------------------------------------------

def _masked_cost(x, y, mask_x, mask_y, pad_cost=0.0):
    """|x_i - y_j|^2 cost with padded rows/cols set to ``pad_cost``;
    leading axes batch."""
    c = ((x[..., :, None, :] - y[..., None, :, :]) ** 2).sum(dim=-1)
    valid = mask_x[..., :, None] * mask_y[..., None, :]
    return torch.where(valid == 1, c, pad_cost)


def sinkhorn_masked(x: torch.Tensor, y: torch.Tensor, mask_x: torch.Tensor,
                    mask_y: torch.Tensor, eps: float = 0.1,
                    max_iter: int = 100, thresh: float = 1e-1
                    ) -> torch.Tensor:
    """Entropic OT between masked point clouds (reference:
    metrics.py:107-203), log-domain, padded marginals of zero mass.

    ``x`` (..., n, 2), ``y`` (..., m, 2), masks (..., n) / (..., m): the
    leading axes are independent frames, each stopping at ``max_iter`` or
    once its |Δu| sum falls below ``thresh``, as the JAX package's vmapped
    ``lax.while_loop`` stops it.  Returns the cost per frame (...)."""
    x, y = _finite(x), _finite(y)
    C = _masked_cost(x, y, mask_x, mask_y)
    nx = torch.clamp_min(mask_x.sum(dim=-1, keepdim=True), 1.0)
    ny = torch.clamp_min(mask_y.sum(dim=-1, keepdim=True), 1.0)
    log_mu = torch.log(mask_x / nx + 1e-8)
    log_nu = torch.log(mask_y / ny + 1e-8)
    valid = (mask_x[..., :, None] * mask_y[..., None, :]) == 1

    def M(u, v):
        return torch.where(valid, (-C + u[..., :, None] + v[..., None, :])
                           / eps, NEG_BIG)

    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    err = torch.full(x.shape[:-2], math.inf, device=x.device)
    for it in range(max_iter):
        active = err >= thresh
        if it % _STOP_CHECK == 0 and not bool(active.any()):
            break
        u1 = u
        un = eps * (log_mu - torch.logsumexp(M(u, v), dim=-1)) + u
        vn = eps * (log_nu - torch.logsumexp(M(un, v), dim=-2)) + v
        errn = ((un - u1) * mask_x).abs().sum(dim=-1)
        u = torch.where(active[..., None], un, u)
        v = torch.where(active[..., None], vn, v)
        err = torch.where(active, errn, err)
    pi = torch.exp(M(u, v)) * (mask_x[..., :, None] * mask_y[..., None, :])
    return (pi * C).sum(dim=(-2, -1))


def sinkhorn_masked_chunked(x: torch.Tensor, y: torch.Tensor,
                            mask_x: torch.Tensor, mask_y: torch.Tensor,
                            eps: float = 0.1, max_iter: int = 100,
                            thresh: float = 1e-1, block: int = 2048
                            ) -> torch.Tensor:
    """Streaming Sinkhorn for one frame: :func:`sinkhorn_masked`'s
    iteration without the (N, M) cost matrix.  Each potential update
    recomputes cost tiles ``block`` columns (rows) wide and merges their
    logsumexps, two-level as the JAX package does, so memory is
    O(N·block).  The dense-N fallback of the banded Sinkhorn."""
    x, y = _finite(x), _finite(y)
    pad_x = -x.shape[0] % block
    pad_y = -y.shape[0] % block
    x = torch.nn.functional.pad(x, (0, 0, 0, pad_x))
    mask_x = torch.nn.functional.pad(mask_x, (0, pad_x))
    y = torch.nn.functional.pad(y, (0, 0, 0, pad_y))
    mask_y = torch.nn.functional.pad(mask_y, (0, pad_y))
    xb, yb = x.split(block), y.split(block)
    mxb, myb = mask_x.split(block), mask_y.split(block)

    nx = torch.clamp_min(mask_x.sum(), 1.0)
    ny = torch.clamp_min(mask_y.sum(), 1.0)
    log_mu = torch.log(mask_x / nx + 1e-8)
    log_nu = torch.log(mask_y / ny + 1e-8)

    def m_tile(xi, mxi, ui, yj, myj, vj):
        dx = xi[:, 0][:, None] - yj[:, 0][None, :]
        dy = xi[:, 1][:, None] - yj[:, 1][None, :]
        c = dx * dx + dy * dy
        m = (-c + ui[:, None] + vj[None, :]) / eps
        return torch.where((mxi[:, None] * myj[None, :]) == 1, m, NEG_BIG), c

    def lse_rows(u, v):
        blk = [torch.logsumexp(m_tile(x, mask_x, u, yj, myj, vj)[0], dim=-1)
               for yj, myj, vj in zip(yb, myb, v.split(block))]
        return torch.logsumexp(torch.stack(blk), dim=0)

    def lse_cols(u, v):
        blk = [torch.logsumexp(m_tile(xi, mxi, ui, y, mask_y, v)[0], dim=-2)
               for xi, mxi, ui in zip(xb, mxb, u.split(block))]
        return torch.logsumexp(torch.stack(blk), dim=0)

    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    err = torch.full((), math.inf, device=x.device)
    for it in range(max_iter):
        active = err >= thresh
        if it % _STOP_CHECK == 0 and not bool(active):
            break
        u1 = u
        un = eps * (log_mu - lse_rows(u, v)) + u
        vn = eps * (log_nu - lse_cols(un, v)) + v
        errn = ((un - u1) * mask_x).abs().sum()
        u = torch.where(active, un, u)
        v = torch.where(active, vn, v)
        err = torch.where(active, errn, err)

    total = torch.zeros((), device=x.device)
    for yj, myj, vj in zip(yb, myb, v.split(block)):
        m, c = m_tile(x, mask_x, u, yj, myj, vj)
        pi = torch.exp(m) * (mask_x[:, None] * myj[None, :])
        total = total + (pi * c).sum()
    return total


def _active_frames(mask: torch.Tensor) -> torch.Tensor:
    return (mask == 1).sum(dim=-1) > 1


def _reduce_frames(per_frame: torch.Tensor, active: torch.Tensor,
                   mode: str) -> torch.Tensor:
    per_frame = torch.where(active, per_frame, 0.0)
    if mode == "sum":
        return per_frame.sum()
    return per_frame.sum() / torch.clamp_min(active.sum(), 1)


def ot_with_time_mask(p: torch.Tensor, q: torch.Tensor, mask: torch.Tensor,
                      mode: str = "mean", dense_limit: int = 2048
                      ) -> torch.Tensor:
    """Per-frame Sinkhorn OT between predicted and real crowds (reference:
    metrics.py:45-67); frames with ≤ 1 present agent count as 0.

    ``p`` / ``q`` (t, N, 2), ``mask`` (t, N): leading channel axes are the
    caller's to fold in.  Up to ``dense_limit`` agents the frames run
    batched, in chunks that bound each (chunk, N, N) temporary; above it
    each frame runs the banded Sinkhorn with its exactness proof and falls
    back to the streaming kernel (``ot_banded.py``), each live frame in a
    device span ``scores.ot``."""
    m = (mask == 1).to(p.dtype)
    active = _active_frames(mask)
    n = p.shape[-2]
    if n > dense_limit:
        from piml_tpu_torch.metrics.ot_banded import sinkhorn_banded_or_dense

        # frames that count 0 anyway are skipped: one host read
        live = active.tolist()
        costs = []
        for t in range(p.shape[0]):
            if not live[t]:
                costs.append(torch.zeros((), device=p.device))
                continue
            with annotate("scores.ot", device=True):
                costs.append(sinkhorn_banded_or_dense(p[t], q[t], m[t], m[t]))
        per_frame = torch.stack(costs)
    else:
        step = _frame_chunk(n * n)
        per_frame = torch.cat([
            sinkhorn_masked(p[s:s + step], q[s:s + step], m[s:s + step],
                            m[s:s + step])
            for s in range(0, p.shape[0], step)])
    return _reduce_frames(per_frame, active, mode)


# ---------------------------------------------------------------------------
# MMD
# ---------------------------------------------------------------------------

def mmd_masked(source: torch.Tensor, target: torch.Tensor,
               mask_s: torch.Tensor, mask_t: torch.Tensor,
               kernel_mul: float = 2.0, kernel_num: int = 5) -> torch.Tensor:
    """Multi-kernel Gaussian MMD between masked point sets (reference:
    metrics.py:207-273); leading axes are independent frames.  Bandwidth =
    mean pairwise L2 over valid pairs, spread over ``kernel_num`` scales."""
    source, target = _finite(source), _finite(target)
    total = torch.cat([source, target], dim=-2)
    mask = torch.cat([mask_s, mask_t], dim=-1)
    valid = mask[..., :, None] * mask[..., None, :]

    l2 = ((total[..., :, None, :] - total[..., None, :, :]) ** 2).sum(dim=-1)
    l2 = l2 * valid
    n_samples = torch.clamp_min(mask.sum(dim=-1), 2.0)
    bandwidth = l2.sum(dim=(-2, -1)) / (n_samples ** 2 - n_samples)
    bandwidth = bandwidth / (kernel_mul ** (kernel_num // 2))
    # degenerate identical clouds: floor the bandwidth so MMD(x, x) = 0
    bandwidth = torch.clamp_min(bandwidth, 1e-12)[..., None, None]

    kernels = torch.zeros_like(l2)
    for i in range(kernel_num):
        kernels = kernels + torch.exp(-l2 / (bandwidth * kernel_mul ** i))
    kernels = kernels * valid

    n = source.shape[-2]
    ns = torch.clamp_min(mask_s.sum(dim=-1), 1.0)
    nt = torch.clamp_min(mask_t.sum(dim=-1), 1.0)
    xx = kernels[..., :n, :n].sum(dim=(-2, -1)) / (ns * ns)
    yy = kernels[..., n:, n:].sum(dim=(-2, -1)) / (nt * nt)
    xy = kernels[..., :n, n:].sum(dim=(-2, -1)) / (ns * nt)
    yx = kernels[..., n:, :n].sum(dim=(-2, -1)) / (nt * ns)
    return xx + yy - xy - yx


def mmd_masked_chunked(source: torch.Tensor, target: torch.Tensor,
                       mask_s: torch.Tensor, mask_t: torch.Tensor,
                       kernel_mul: float = 2.0, kernel_num: int = 5,
                       block: int = 4096) -> torch.Tensor:
    """Streaming twin of :func:`mmd_masked` for one frame: the kernel
    matrix is taken ``block`` rows at a time, never whole.

    As in the JAX package: the shared bandwidth comes from the closed form
    ``Σ_ij m_i m_j |t_i - t_j|² = 2[(Σm)(Σ m|t̃|²) - |Σ m t̃|²]`` on
    mean-centred points, and with ``kernel_mul = 2`` the scales are powers
    of one another, so the kernel sum is one exp and squarings."""
    source, target = _finite(source), _finite(target)
    total = torch.cat([source, target], dim=0)
    mask = torch.cat([mask_s, mask_t], dim=0)
    is_s = torch.cat([mask_s, torch.zeros_like(mask_t)], dim=0)
    is_t = torch.cat([torch.zeros_like(mask_s), mask_t], dim=0)

    n_samples = torch.clamp_min(mask.sum(), 2.0)
    center = (total * mask[:, None]).sum(dim=0) / n_samples
    tc = (total - center) * mask[:, None]
    sq = (tc ** 2).sum()
    l2_sum = 2.0 * (n_samples * sq - (tc.sum(dim=0) ** 2).sum())
    bandwidth = l2_sum / (n_samples ** 2 - n_samples)
    bandwidth = bandwidth / (kernel_mul ** (kernel_num // 2))
    bandwidth = torch.clamp_min(bandwidth, 1e-12)

    mul_is_pow2 = float(kernel_mul) == 2.0
    tot_x, tot_y = total[:, 0], total[:, 1]
    quad = torch.zeros(4, device=total.device)
    for row, mrow, ss, tt in zip(total.split(block), mask.split(block),
                                 is_s.split(block), is_t.split(block)):
        dx = row[:, 0][:, None] - tot_x[None, :]
        dy = row[:, 1][:, None] - tot_y[None, :]
        d = dx * dx + dy * dy
        d = d * (mrow[:, None] * mask[None, :])
        if mul_is_pow2:
            e = torch.exp(-d / (bandwidth * kernel_mul ** (kernel_num - 1)))
            k = e
            for _ in range(kernel_num - 1):
                e = e * e
                k = k + e
        else:
            k = torch.zeros_like(d)
            for i in range(kernel_num):
                k = k + torch.exp(-d / (bandwidth * kernel_mul ** i))
        k = k * (mrow[:, None] * mask[None, :])
        ks = k @ is_s
        kt = k @ is_t
        quad = quad + torch.stack([(ss * ks).sum(), (tt * kt).sum(),
                                   (ss * kt).sum(), (tt * ks).sum()])
    ns = torch.clamp_min(mask_s.sum(), 1.0)
    nt = torch.clamp_min(mask_t.sum(), 1.0)
    return (quad[0] / (ns * ns) + quad[1] / (nt * nt)
            - quad[2] / (ns * nt) - quad[3] / (nt * ns))


def mmd_with_time_mask(p: torch.Tensor, q: torch.Tensor, mask: torch.Tensor,
                       mode: str = "mean", dense_limit: int = 2048
                       ) -> torch.Tensor:
    """Per-frame MMD (reference: metrics.py:70-91); leading channel axes
    fold into the frame axis as the reference folds them.  Above
    ``dense_limit`` agents each frame runs the streaming kernel."""
    if mask.dim() > 2:
        mask = mask.reshape(-1, mask.shape[-1])
        p = p.reshape(mask.shape[0], p.shape[-2], p.shape[-1])
        q = q.reshape(mask.shape[0], q.shape[-2], q.shape[-1])
    m = (mask == 1).to(p.dtype)
    n = p.shape[-2]
    if n > dense_limit:
        per_frame = torch.stack([mmd_masked_chunked(p[t], q[t], m[t], m[t])
                                 for t in range(p.shape[0])])
    else:
        step = _frame_chunk(8 * n * n)
        per_frame = torch.cat([
            mmd_masked(p[s:s + step], q[s:s + step], m[s:s + step],
                       m[s:s + step])
            for s in range(0, p.shape[0], step)])
    return _reduce_frames(per_frame, _active_frames(mask), mode)

"""Plain PyTorch reference of the scores an evaluation rollout is judged by
(the published code's ``src/functions/metrics.py`` and the test branch of
``src/models/simulators.py:465-554``, as the measured program states
them): the displacement errors, the per-frame entropic optimal-transport
cost (Sinkhorn, log domain) and multi-kernel MMD between the predicted and
the real crowd, and the contact counts with the "friends" filter.

Every quantity is taken densely over all pairs, in blocks of rows where a
pair tensor would not fit beside the program's state; it imports nothing
of the measured program.  Departures: the Sinkhorn loop reads its stop
test on the host every iteration (the program reads it every few and
freezes converged frames, which gives each frame the same iterations),
and block sums are added in float64.
"""

from __future__ import annotations

from typing import Dict

import torch

ROW_BLOCK = 2 ** 24     # pair elements per block of rows
NEG_BIG = -1e9


def _finite(x):
    return torch.where(torch.isfinite(x), x, 0.0)


def _blocks(n: int, cols: int):
    rows = max(1, ROW_BLOCK // max(cols, 1))
    return [(s, min(n, s + rows)) for s in range(0, n, rows)]


def contact_total(position: torch.Tensor, threshold: float,
                  friends_frames: int = 25) -> float:
    """``Σ_t Σ_{i≠j} [|p_j − p_i| < threshold]`` over ``(T, N, 2)``,
    leaving out the pairs ("friends") in contact in more than
    ``friends_frames`` frames; absent agents touch no one."""
    n = position.shape[1]
    total = 0.0
    ids = torch.arange(n, device=position.device)
    for s, e in _blocks(n, n * position.shape[0]):
        d = torch.linalg.vector_norm(position[:, None, :, :]
                                     - position[:, s:e, None, :], dim=-1)
        hit = (d < threshold) & (ids[s:e, None] != ids[None, :])
        count = hit.sum(0).to(torch.float64)              # frames a pair
        total += float((count * (count <= friends_frames)).sum())
    return total


def sinkhorn(x, y, mask_x, mask_y, eps: float = 0.1, max_iter: int = 100,
             thresh: float = 0.1) -> float:
    """Entropic OT cost between two masked clouds ``(N, 2)`` of one frame:
    log-domain Sinkhorn on ``|x_i − y_j|²``, marginals uniform over the
    present points, stopping once the potential ``u`` moves by less than
    ``thresh`` (summed over the present rows) or after ``max_iter``
    iterations."""
    x, y = _finite(x), _finite(y)
    cost = ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)
    valid = (mask_x[:, None] * mask_y[None, :]) == 1
    log_mu = torch.log(mask_x / torch.clamp_min(mask_x.sum(), 1.0) + 1e-8)
    log_nu = torch.log(mask_y / torch.clamp_min(mask_y.sum(), 1.0) + 1e-8)

    def m(u, v):
        return torch.where(valid, (-cost + u[:, None] + v[None, :]) / eps,
                           NEG_BIG)

    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(max_iter):
        u_next = eps * (log_mu - torch.logsumexp(m(u, v), dim=1)) + u
        v = eps * (log_nu - torch.logsumexp(m(u_next, v), dim=0)) + v
        err = float(((u_next - u) * mask_x).abs().sum())
        u = u_next
        if err < thresh:
            break
    plan = torch.exp(m(u, v)) * valid
    return float((plan * cost).sum(dtype=torch.float64))


def mmd(source, target, mask_s, mask_t, kernel_mul: float = 2.0,
        kernel_num: int = 5) -> float:
    """Multi-kernel Gaussian MMD between two masked clouds ``(N, 2)``:
    bandwidth the mean squared distance over distinct present pairs of
    both clouds together, ÷ ``kernel_mul^(kernel_num // 2)``, then
    ``kernel_num`` scales ``× kernel_mul^i``."""
    pts = torch.cat([_finite(source), _finite(target)])
    mask = torch.cat([mask_s, mask_t])
    n_all, n = pts.shape[0], source.shape[0]
    count = max(float(mask.sum()), 2.0)

    def block(s, e):
        d = ((pts[s:e, None, :] - pts[None, :, :]) ** 2).sum(-1)
        return d * (mask[s:e, None] * mask[None, :])

    l2 = sum(float(block(s, e).sum(dtype=torch.float64))
             for s, e in _blocks(n_all, n_all))
    bw = max(l2 / (count * count - count) / kernel_mul ** (kernel_num // 2),
             1e-12)
    quad = torch.zeros(2, 2, dtype=torch.float64, device=pts.device)
    side = (torch.arange(n_all, device=pts.device) >= n).long()
    for s, e in _blocks(n_all, n_all):
        d = block(s, e)
        k = sum(torch.exp(-d / (bw * kernel_mul ** i))
                for i in range(kernel_num))
        k = k * (mask[s:e, None] * mask[None, :])
        for a in (0, 1):
            rows = side[s:e] == a
            for b in (0, 1):
                quad[a, b] += k[rows][:, side == b].sum(dtype=torch.float64)
    ns = max(float(mask_s.sum()), 1.0)
    nt = max(float(mask_t.sum()), 1.0)
    return float(quad[0, 0] / (ns * ns) + quad[1, 1] / (nt * nt)
                 - quad[0, 1] / (ns * nt) - quad[1, 0] / (nt * ns))


def scores(position, mask_pred, labels, waypoints, dest_num, skip: int,
           threshold: float) -> Dict[str, float]:
    """The scores of one rollout: ``position`` ``(T, N, 2)`` (the real
    frames before ``skip``, the predicted ones from it, NaN where absent),
    ``mask_pred`` ``(T, N)`` the predictable agent-frames, ``labels`` the
    real positions.  An agent that left the prediction early but is still
    predictable stands at its last waypoint.  Returns the means the
    program reports: per predictable row (``mse``, ``mae``), per frame
    with a predictable agent (``ot``, ``mmd``), and the contact totals
    over the predicted frames (``collision`` at ``threshold``,
    ``hard_collision`` at half of it)."""
    n = position.shape[1]
    last = waypoints[torch.clamp_min(dest_num.long() - 1, 0),
                     torch.arange(n, device=position.device)]
    gone = (mask_pred == 1) & torch.isnan(position[..., 0])
    post = torch.where(gone[..., None], last[None], position)
    m = (mask_pred == 1)
    diff = torch.where(m[..., None], post - labels, 0.0)
    mse = float((diff ** 2).sum(dtype=torch.float64))
    mae = float(torch.linalg.vector_norm(diff, dim=-1)
                .sum(dtype=torch.float64))
    rows = int(m.sum())
    frames = int((m.sum(-1) > 0).sum())
    ot = mm = 0.0
    mf = m.to(position.dtype)
    for t in range(position.shape[0]):
        if int(m[t].sum()) > 1:
            ot += sinkhorn(post[t], labels[t], mf[t], mf[t])
            mm += mmd(post[t], labels[t], mf[t], mf[t])
    rows, frames = max(rows, 1), max(frames, 1)
    pred = position[skip:]
    return {"loss": mse / rows, "mse": mse / rows, "mae": mae / rows,
            "ot": ot / frames, "mmd": mm / frames,
            "collision": contact_total(pred, threshold),
            "hard_collision": contact_total(pred, threshold / 2)}


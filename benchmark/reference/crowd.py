"""Plain PyTorch reference of the crowd model, the rollout and the BPTT loss.

A frozen, self-contained statement of the mathematics the measured
program runs (the physics-infused PINN-SF model of "Physics-infused
Machine Learning for Crowd Simulation", KDD'22, as the port implements
it): neighbour selection and features, the PINNSF forward with its
bottleneck and collision-head variants, the lagged-Euler frame with
waypoints, retirement and teleport-in, the time-decayed BPTT loss with
its collision, collision-head and message terms, and Adam with coupled
weight decay.  It imports nothing of the measured program: weights come
in as a ``{name: tensor}`` dict, inputs as plain tensors.

Neighbour selection keeps the two arithmetics the program's routes use,
so that a sound program meets the reference bit for bit where it can:
``direct`` differencing (the hand-written kernels and their plain
versions, taken on a card for frames of at least ``GATE`` pairs) and the
``expansion`` ``|p|² + |q|² − 2 p·q`` (every other frame).  Both order
candidates by (distance, index) and keep the ``k`` nearest in view.  One
arithmetic for every frame flips selections against a sound program by
more than the faults that ``correct`` must catch (PERF.md, section 2), so
``kernel_route`` is the one statement of the program's routing gate in
the benchmark.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.nn import functional as F

GATE = 2 ** 21          # pairs of a frame from which the card's kernels select
ROW_BLOCK = 2 ** 24     # pair elements per block of rows


def cos_threshold(angle_deg: float) -> float:
    """The field-of-view threshold ``f32(cos(3.14·θ/180))``: the literal
    3.14 (not pi) is the published code's, and it excludes the self pair
    at θ = 90°."""
    return float(np.float32(math.cos(3.14 * angle_deg / 180.0)))


def lane_padded(m: int) -> int:
    return max(128, -(-m // 128) * 128)


def kernel_route(n_rows: int, m_cols: int, on_card: bool) -> bool:
    """Whether the program selects this pass with its direct-differencing
    kernels: on a card, with ``n·lane(n) ≥ GATE`` (the agent pass) and
    ``n·lane(m) ≥ GATE``."""
    return (on_card and n_rows * lane_padded(n_rows) >= GATE
            and n_rows * lane_padded(m_cols) >= GATE)


def nan0(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(x), 0.0, x)


def heading(v0: torch.Tensor) -> torch.Tensor:
    """Unit heading of a velocity (NaN already zeroed); zero stays zero."""
    n = torch.linalg.vector_norm(v0, dim=-1, keepdim=True)
    return v0 / torch.where(n == 0, 0.1, n)


def heading_filled(v0: torch.Tensor) -> torch.Tensor:
    """Heading of a ``(T, N, 2)`` track with zero velocities filled from
    the next nonzero one, else the last one before it."""
    nz = torch.linalg.vector_norm(v0, dim=-1, keepdim=True) > 0
    back = torch.empty_like(v0)
    carry = torch.zeros_like(v0[0])
    for t in reversed(range(v0.shape[0])):
        carry = torch.where(nz[t], v0[t], carry)
        back[t] = carry
    nz2 = torch.linalg.vector_norm(back, dim=-1, keepdim=True) > 0
    out = torch.empty_like(v0)
    carry = torch.zeros_like(v0[0])
    for t in range(v0.shape[0]):
        carry = torch.where(nz2[t], back[t], carry)
        out[t] = carry
    return heading(out)


@torch.no_grad()
def select(pos: torch.Tensor, head: torch.Tensor, objects: torch.Tensor,
           k: int, angle: float, same: bool, direct: bool, radius: float):
    """``(dist, idx)`` ``(N, k)`` of the ``k`` nearest objects in view and
    within ``radius`` of each row of one frame, nearest first, the lower
    index first on equal distances; +inf fills the slots beyond (their
    indices are arbitrary: every caller zeroes those features)."""
    n, m = pos.shape[0], objects.shape[0]
    k = min(k, m)
    thr = torch.tensor(cos_threshold(angle), device=pos.device)
    absent_p = torch.isnan(pos).any(-1)
    absent_o = torch.isnan(objects).any(-1)
    p0, o0 = nan0(pos), nan0(objects)
    out_d = torch.empty((n, k), device=pos.device)
    out_i = torch.empty((n, k), dtype=torch.long, device=pos.device)
    rows = max(1, ROW_BLOCK // max(m, 1))
    cols = torch.arange(m, device=pos.device)
    for s in range(0, n, rows):
        e = min(n, s + rows)
        invalid = absent_p[s:e, None] | absent_o[None, :]
        self_pair = (torch.arange(s, e, device=pos.device)[:, None]
                     == cols[None, :]) if same else None
        if direct:
            dx = objects[None, :, 0] - pos[s:e, 0:1]
            dy = objects[None, :, 1] - pos[s:e, 1:2]
            d2 = dx * dx + dy * dy
            rel_h = dx * head[s:e, 0:1] + dy * head[s:e, 1:2]
            if same:
                d2 = torch.where(self_pair, 0.0, d2)
                rel_h = torch.where(self_pair, 0.0, rel_h)
            out_view = rel_h < thr * torch.clamp_min(torch.sqrt(d2), 1e-8)
            d2 = torch.where(out_view | invalid, math.inf, d2)
            key = torch.where(torch.sqrt(d2) <= radius, d2, math.inf)
        else:
            ps = p0[s:e]
            dist2 = ((ps * ps).sum(-1)[:, None] + (o0 * o0).sum(-1)[None, :]
                     - 2.0 * (ps @ o0.T))
            dist = torch.where(invalid, math.inf,
                               torch.sqrt(torch.clamp_min(dist2, 0.0)))
            hs = head[s:e]
            rel_dot_h = hs @ o0.T - (ps * hs).sum(-1)[:, None]
            h_norm = torch.clamp_min(torch.linalg.vector_norm(hs, dim=-1),
                                     1e-8)
            cos = rel_dot_h / torch.clamp_min(dist, 1e-8) / h_norm[:, None]
            cos = torch.where(invalid | torch.isnan(cos), -1.0, cos)
            if same:
                pin = self_pair & ~invalid
                dist = torch.where(pin, 0.0, dist)
                cos = torch.where(pin, 0.0, cos)
            dist = torch.where(cos < thr, math.inf, dist)
            key = torch.where(dist <= radius, dist, math.inf)
        d, idx = torch.topk(key, k, dim=-1, largest=False)
        # (value, index) order among the k: by index, then stably by value
        by_id = torch.argsort(idx, dim=-1)
        d, idx = torch.gather(d, 1, by_id), torch.gather(idx, 1, by_id)
        by_d = torch.argsort(d, dim=-1, stable=True)
        d, idx = torch.gather(d, 1, by_d), torch.gather(idx, 1, by_d)
        out_d[s:e] = torch.sqrt(d) if direct else d
        out_i[s:e] = idx
    return out_d, out_i


def frame_features(p, v, a, dest, obstacles, nb, on_card: bool,
                   head: Optional[torch.Tensor] = None):
    """Neighbour, obstacle and destination features of one frame
    ``(N, 2)`` (or a batch ``(C, N, 2)``, one frame a channel)."""
    if p.ndim == 3:
        outs = [frame_features(p[c], v[c], a[c], dest[c], obstacles, nb,
                               on_card, None if head is None else head[c])
                for c in range(p.shape[0])]
        return tuple(torch.stack(x) for x in zip(*outs))
    v0, a0 = nan0(v), nan0(a)
    if head is None:
        head = heading(v0)
    state = torch.cat([p, v0, a0], dim=-1)
    n, m = p.shape[0], obstacles.shape[0]
    pd, pi = select(p, head, p, nb["topk_ped"], nb["sight_angle_ped"], True,
                    kernel_route(n, n, on_card), nb["dist_threshold_ped"])
    rel = state[pi] - state[:, None, :]
    keep = (pd <= nb["dist_threshold_ped"])[..., None]
    ped = torch.where(keep & torch.isfinite(rel), rel, 0.0)
    od, oi = select(p, head, obstacles, nb["topk_obs"], nb["sight_angle_obs"],
                    False, kernel_route(n, m, on_card), nb["dist_threshold_obs"])
    obs_state = torch.cat([obstacles, torch.zeros_like(obstacles),
                           torch.zeros_like(obstacles)], dim=-1)
    rel_o = obs_state[oi] - state[:, None, :]
    keep_o = (od <= nb["dist_threshold_obs"])[..., None]
    obs = torch.where(keep_o & torch.isfinite(rel_o), rel_o, 0.0)
    return ped, obs, nan0(dest - p)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _mlp(w, prefix: str, x, n: int, out_relu: bool = False):
    for i in range(n):
        x = F.linear(x, w[f"{prefix}.dense_{i}.weight"],
                     w[f"{prefix}.dense_{i}.bias"])
        if i < n - 1 or out_relu:
            x = F.relu(x)
    return x


def _dropout(x, p: float, gens):
    """Inverted dropout, each channel's mask from its own generator."""
    if gens is None or p <= 0:
        return x
    keep_p = torch.full(x.shape[1:], 1.0 - p, device=x.device)
    keep = torch.stack([torch.bernoulli(keep_p, generator=g) for g in gens])
    return torch.where(keep > 0, x / (1.0 - p), 0.0)


class Out(NamedTuple):
    acc: torch.Tensor
    ped_msgs: torch.Tensor
    coll_pred: Optional[torch.Tensor]


def forward(w: Dict[str, torch.Tensor], spec: dict, ped, obs, self_f,
            gens=None) -> Out:
    """The PINNSF forward: per-edge encoder and one residual block (the
    published code keeps only the last block), dropout, then either a
    per-edge bottleneck decoder summed over the edges or a decoder on the
    summed messages; plus the analytic goal force; an optional per-edge
    sigmoid collision head; ``clamp``: the acceleration clipped to ±clamp."""
    enc_n, dec_n = spec["encoder_hidden_layers"], spec["decoder_hidden_layers"]
    bottleneck = spec["bottleneck"]
    acc = None
    parts = {}
    for b, x in (("ped", ped), ("obs", obs)):
        enc = _mlp(w, f"{b}_encoder", x, enc_n)
        res = enc + _mlp(w, f"{b}_processor.block_0.MLP_0", enc, 1,
                         out_relu=True)
        emb = _dropout(res, spec["dropout"], gens)
        if bottleneck:
            dec = _mlp(w, f"{b}_decoder", emb, dec_n)
            msgs = _mlp(w, f"{b}_predictor", dec, 1)
            a_b = msgs.sum(dim=-2)
        else:
            dec, msgs = None, emb
            a_b = _mlp(w, f"{b}_predictor",
                       _mlp(w, f"{b}_decoder", emb.sum(dim=-2), dec_n), 1)
        parts[b] = (dec, msgs)
        acc = a_b if acc is None else acc + a_b
    ds = self_f[..., -1:]
    dest = self_f[..., :2]
    nrm = torch.linalg.vector_norm(dest, dim=-1, keepdim=True)
    nrm = torch.where(nrm == 0, nrm + 0.1, nrm)
    goal = (ds * (dest / nrm) - self_f[..., 2:4]) / spec["tau"]
    acc = acc + goal
    coll = None
    head = spec.get("collision_head")
    if head:
        src = parts["ped"][0] if head == "decoder" else parts["ped"][1]
        coll = torch.sigmoid(_mlp(w, "collision_head", src, 2))[..., 0]
    if spec.get("clamp"):
        acc = torch.clamp(acc, -spec["clamp"], spec["clamp"])
    return Out(acc, parts["ped"][1], coll)


# ---------------------------------------------------------------------------
# the frame and the rollout
# ---------------------------------------------------------------------------

class State(NamedTuple):
    p: torch.Tensor
    v: torch.Tensor
    a: torch.Tensor
    dest: torch.Tensor
    dest_idx: torch.Tensor
    hist_v: torch.Tensor
    ped: torch.Tensor
    obs: torch.Tensor
    self_f: torch.Tensor


class Spawn(NamedTuple):
    new: torch.Tensor
    p: torch.Tensor
    v: torch.Tensor
    a: torch.Tensor
    dest: torch.Tensor
    dest_idx: torch.Tensor
    hist_v: torch.Tensor


class Rec(NamedTuple):
    p: torch.Tensor
    v: torch.Tensor
    a: torch.Tensor
    mask: torch.Tensor
    coll: torch.Tensor
    hard: torch.Tensor
    coll_pred: torch.Tensor
    true_coll: torch.Tensor
    msg_l1: torch.Tensor


def collision_label(ped: torch.Tensor) -> torch.Tensor:
    """Would-collide-within-1 s label of each neighbour edge."""
    t = torch.arange(10, dtype=ped.dtype, device=ped.device) * 0.1
    fut = ped[..., None, :2] + ped[..., None, 2:4] * t[:, None]
    d = torch.linalg.vector_norm(fut, dim=-1)
    return ((d < 0.5) & (d != 0)).any(dim=-1).to(ped.dtype)


@torch.no_grad()
def contacts(pos: torch.Tensor, thr: float) -> torch.Tensor:
    """Per-agent count of others closer than ``thr``: ``(..., N, 2) →
    (..., N)``, 0 where absent; in blocks of rows."""
    n = pos.shape[-2]
    lead = math.prod(pos.shape[:-2])
    rows = max(1, 2 ** 25 // max(lead * n, 1))
    cols = pos[..., None, :, :]
    out = []
    for s in range(0, n, rows):
        d = torch.linalg.vector_norm(cols - pos[..., s:s + rows, None, :],
                                     dim=-1)
        eye = (torch.arange(s, s + d.shape[-2], device=pos.device)[:, None]
               == torch.arange(n, device=pos.device)[None, :])
        hit = (d < thr).to(pos.dtype) - eye.to(pos.dtype)
        out.append(torch.where(torch.isnan(d), 0.0, hit).sum(-1))
    return torch.cat(out, dim=-1)


def step(w, spec, sim: dict, state: State, spawn: Spawn, waypoints,
         dest_num, obstacles, desired_speed, on_card: bool,
         seeds: Optional[Sequence[int]] = None):
    """One frame: the model, lagged Euler, waypoint advance and retirement,
    teleport-in, then the next frame's features."""
    dt = sim["time_unit"]
    present = (~torch.isnan(state.p[..., 0])).to(state.p.dtype)
    gens = None
    if seeds is not None:
        gens = [torch.Generator(device=state.p.device).manual_seed(int(s))
                for s in seeds]
    out = forward(w, spec, state.ped, state.obs, state.self_f, gens)
    lead = state.p.ndim - 2
    msg_l1 = out.ped_msgs.abs().flatten(lead).sum(-1)
    if sim["track_collisions"]:
        ps = state.p.detach()
        coll = contacts(ps, sim["collision_threshold"])
        hard = contacts(ps, sim["collision_threshold"] / 2)
    else:
        coll = hard = torch.zeros_like(present)
    k1 = state.ped.shape[-2]
    if sim["track_labels"] and out.coll_pred is not None:
        coll_pred, true_coll = out.coll_pred, collision_label(state.ped)
    else:
        coll_pred = torch.zeros(state.p.shape[:-1] + (k1,),
                                device=state.p.device)
        true_coll = torch.zeros_like(coll_pred)
    v_next = state.v + state.a * dt
    p_next = state.p + state.v * dt
    dis = torch.linalg.vector_norm(state.p - state.dest, dim=-1)
    dest_idx = state.dest_idx + (dis < 0.5).to(state.dest_idx.dtype)
    arrived = dest_idx > dest_num - 1
    if sim["retire"]:
        p_next = torch.where(arrived[..., None], torch.nan, p_next)
    dest_idx = torch.where(arrived, dest_idx - 1, dest_idx)
    agents = torch.arange(waypoints.shape[1], device=waypoints.device)
    dest_next = nan0(waypoints)[dest_idx.long(), agents]
    hist_v = torch.cat([state.hist_v[..., 2:], v_next], dim=-1)
    a_next = out.acc
    new = spawn.new[..., None] == 1
    p_next = torch.where(new, spawn.p, p_next)
    v_next = torch.where(new, spawn.v, v_next)
    a_next = torch.where(new, spawn.a, a_next)
    dest_next = torch.where(new, spawn.dest, dest_next)
    dest_idx = torch.where(spawn.new == 1, spawn.dest_idx, dest_idx)
    hist_v = torch.where(new, spawn.hist_v, hist_v)
    with torch.no_grad():
        v0 = nan0(v_next)
        head = heading(v0)
    ped, obs, dest_f = frame_features(p_next, v_next, a_next, dest_next,
                                      obstacles, sim["neighbor"], on_card,
                                      head)
    ds = desired_speed.expand(p_next.shape[:-1] + (1,))
    self_f = torch.cat([dest_f, hist_v, a_next, ds], dim=-1)
    nxt = State(p_next, v_next, a_next, dest_next, dest_idx, hist_v, ped,
                obs, self_f)
    return nxt, Rec(state.p, state.v, state.a, present, coll, hard,
                    coll_pred, true_coll, msg_l1)


def initial_state(p, v, a, dest, dest_idx, obstacles, desired_speed,
                  hist_v, nb, on_card: bool, head=None) -> State:
    """The first frame's state with its features worked out here;
    ``head``: the heading, where it is not the frame's own velocity's."""
    ped, obs, dest_f = frame_features(p, v, a, dest, obstacles, nb, on_card,
                                      head)
    ds = desired_speed.expand(p.shape[:-1] + (1,))
    self_f = torch.cat([dest_f, hist_v, a, ds], dim=-1)
    return State(p, v, a, dest, dest_idx.to(torch.int32), hist_v, ped, obs,
                 self_f)


def rollout(w, spec, sim, state: State, spawns: Spawn, waypoints, dest_num,
            obstacles, desired_speed, on_card: bool, axis: int = 0,
            seeds=None):
    """``T`` frames from ``state``; records stacked along ``axis`` (0 for
    one scene's ``(T, N, ...)``, 1 for a channel batch's ``(C, T, ...)``).
    ``seeds`` ``(C, T)``: each frame's dropout seeds."""
    recs: List[Rec] = []
    for t in range(spawns.new.shape[axis]):
        sp = Spawn(*(x.select(axis, t) for x in spawns))
        sd = None if seeds is None else [int(s) for s in seeds[:, t]]
        state, r = step(w, spec, sim, state, sp, waypoints, dest_num,
                        obstacles, desired_speed, on_card, sd)
        recs.append(r)
    return state, Rec(*(torch.stack(x, dim=axis) for x in zip(*recs)))


# ---------------------------------------------------------------------------
# the BPTT finetune loss and Adam
# ---------------------------------------------------------------------------

def spawns_from_track(position, velocity, acceleration, destination,
                      dest_idx, hist_v, mask_p, mask_p_pred) -> Spawn:
    """Teleport-in schedule of time-major ``(T, ...)`` tracks: frame
    ``t + 1`` is injected by step ``t``; agents present but not yet
    predictable are the new ones."""
    def shift(x):
        return torch.cat([x[1:], torch.zeros_like(x[:1])], dim=0)

    return Spawn(shift((mask_p - mask_p_pred).to(position.dtype)),
                 shift(nan0(position)), shift(velocity), shift(acceleration),
                 shift(nan0(destination)), shift(dest_idx).to(torch.int32),
                 shift(hist_v))


def _decay(t_len: int, decay: float, device) -> torch.Tensor:
    t = torch.arange(t_len, dtype=torch.float32, device=device)
    return (decay ** (t_len - t - 1)).reshape(1, -1, 1, 1)


def _perp_mse(pred, labels, decay):
    ni = labels[:, -1:] - labels[:, 0:1]
    ni = ni / (torch.linalg.vector_norm(ni, dim=-1, keepdim=True) + 1e-6)
    pp = pred - (pred * ni).sum(-1, keepdim=True) * ni
    lp = labels - (labels * ni).sum(-1, keepdim=True) * ni
    return (pp - lp) ** 2 * _decay(pred.shape[1], decay, pred.device)


def bptt_loss(w, spec, loss_cfg: dict, sim: dict, batch: dict,
              seeds: torch.Tensor, on_card: bool) -> torch.Tensor:
    """The finetune loss of a ``(C, T, N, ...)`` batch of windows: each
    window rolled out from its frame 0 with ground-truth teleport-in, then
    time-decayed position MSE, collision-gated perpendicular penalties
    (abnormal-masked), BCE of the collision head over live slots and the
    L1 of the messages.  ``batch`` holds the windows' raw tracks."""
    pos, mask_p, mask_pp = batch["position"], batch["mask_p"], batch["mask_p_pred"]
    C, T = pos.shape[:2]
    hist = batch["hist_v"]
    state = initial_state(pos[:, 0], batch["velocity"][:, 0],
                          batch["acceleration"][:, 0],
                          batch["destination"][:, 0], batch["dest_idx"][:, 0],
                          batch["obstacles"], batch["desired_speed"][:, None],
                          hist[:, 0], sim["neighbor"], on_card,
                          batch.get("heading0"))
    tm = [x.movedim(1, 0) for x in (pos, batch["velocity"],
                                     batch["acceleration"],
                                     batch["destination"], batch["dest_idx"],
                                     hist, mask_p, mask_pp)]
    spawns = Spawn(*(x.movedim(0, 1) for x in spawns_from_track(*tm)))
    _, rec = rollout(w, spec, sim, state, spawns, batch["waypoints"],
                     batch["dest_num"], batch["obstacles"],
                     batch["desired_speed"][:, None], on_card, axis=1,
                     seeds=seeds)
    lc = loss_cfg
    active = (mask_pp.sum(-1, keepdim=True) > 0).to(pos.dtype)    # C, T, 1
    rows = (mask_pp == 1)[..., None]

    def masked(x):
        return nan0(torch.where(rows, x, 0.0))

    p_res = masked(rec.p)
    lab = masked(batch["labels_p"])
    loss = ((p_res - lab) ** 2 * _decay(T, lc["time_decay"], pos.device)).sum()
    if lc["reg_weight"] > 0:
        loss = loss + (rec.msg_l1 * active[..., 0]).sum() * lc["reg_weight"]
    coll = rec.coll * active
    hard = rec.hard * active
    if lc["collision_loss_weight"] > 0:
        # version v2 masks out the abnormal (turning, loitering) agents
        abn = (batch["abnormal_mask"].reshape(1, 1, -1, 1)
               if lc["collision_loss_version"] == "v2" else 1.0)
        perp = _perp_mse(p_res, lab, lc["time_decay"])
        for counts, scale in ((coll, 1.0), (hard, lc["hard_collision_penalty"])):
            gate = (counts.sum(1) > 0).to(pos.dtype)[:, None, :, None]
            loss = loss + ((gate * perp * abn).sum()
                           * lc["collision_loss_weight"] * scale)
    if lc["collision_pred_weight"] > 0:
        live = (rec.mask * active)[..., None]
        pc = torch.clamp(rec.coll_pred * live, 1e-7, 1 - 1e-7)
        tc = rec.true_coll * live
        bce = -(tc * torch.log(pc) + (1 - tc) * torch.log(1 - pc))
        loss = loss + bce.sum() * lc["collision_pred_weight"]
    return loss


class Adam:
    """Adam with L2 decay added to the gradient before the moments."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, wd: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params, self.lr, self.wd = params, lr, wd
        self.b1, self.b2, self.eps, self.t = b1, b2, eps, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Update in place; returns each leaf's gradient as the moments
        take it (weight decay included)."""
        self.t += 1
        taken = {}
        for k, p in self.params.items():
            g = grads[k] + self.wd * p
            taken[k] = g
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            m_hat = self.m[k] / (1 - self.b1 ** self.t)
            v_hat = self.v[k] / (1 - self.b2 ** self.t)
            p -= self.lr * m_hat / (torch.sqrt(v_hat) + self.eps)
        return taken

"""Neighbour features, heading fill, collision and mask helpers.

Counterpart of ``piml_tpu/physics/features.py`` (reference:
src/data/data.py:343-744).  NaN conventions match the reference: absent
agents carry NaN positions, which become +inf distances and therefore
zero-padded features.

Routing of the neighbour selection (``relative_features``) is the JAX
package's, with "the backend is a TPU" read as "the tensor is on a CUDA
device":

- a single frame (rank 2) whose pair grid reaches 2^21 goes through the
  hand-written kernels on the card: K2 (``ops/banded.py``) when
  ``use_grid_topk``, with K1 (``ops/pairwise.py``) as its exact fallback,
  or K1 directly; past ``DENSE_COLUMN_CEILING`` agents the agent pass's
  fallback is a second K2 pass on a half-resolution grid
  (:func:`_banded_wide_fallback`), where the JAX package's dense kernel
  stops;
- ``batched=True`` with a rank-3 ``(C, N, 2)`` batch of frames (the
  channeled BPTT finetune) past the same gate: the channel-batched K2, one
  launch per pass for all channels and ONE exactness decision for the
  whole batch, whose fallback is :func:`nearby_in_sight` over ``(C, N, M)``
  (the JAX package's dense kernel takes single frames only);
- otherwise — and on the CPU — :func:`nearby_in_sight`'s matmul-expansion
  distances.  With ``use_pallas_topk=False`` a large frame takes the banded
  path even on the CPU (its plain version), as JAX does in interpret mode.

The selected distances feed threshold comparisons only, so the selection
runs without autograd; gradients flow through the gathered states.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from piml_tpu_torch.ops import banded, pairwise
from piml_tpu_torch.utils.profiling import annotate

INF = math.inf
_GATE = 2 ** 21
# The JAX package's dense kernel holds its whole column table in one TPU
# core's VMEM and so takes at most 257,536 lane-padded columns
# (``pair_pass_fits`` of piml_tpu/ops/pairwise.py:202-237, a VMEM model the
# port does not carry).  K1 has no such ceiling, but past it the selection
# follows the JAX package's: the agent pass falls back to the half-grid
# banded pass, not to the O(N^2) dense scan.
DENSE_COLUMN_CEILING = 257_536
_PAIR_CHUNK = 2 ** 25   # pair elements per chunk of the contact counts


class NeighborConfig(NamedTuple):
    """Neighbourhood hyper-parameters (reference CLI flags,
    src/main.py:52-57).  ``use_pallas_topk`` / ``use_grid_topk`` keep the
    JAX package's names: they select the dense kernel K1 and the banded
    kernel K2 on the card."""

    topk_ped: int = 6
    topk_obs: int = 10
    sight_angle_ped: float = 90.0
    sight_angle_obs: float = 90.0
    dist_threshold_ped: float = 4.0
    dist_threshold_obs: float = 4.0
    use_pallas_topk: bool = True
    use_grid_topk: bool = True


def _on_card(x: torch.Tensor) -> bool:
    """Whether the selection takes the card's route (the JAX package's
    "the backend is a TPU"): the tensor lies on a CUDA device."""
    return x.is_cuda


def _nan_to_zero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(x), 0.0, x)


def _norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1, keepdim=keepdim)


# ----------------------------------------------------------------------------
# heading direction
# ----------------------------------------------------------------------------

def _fill_zero_velocity(velocity: torch.Tensor) -> torch.Tensor:
    """Backward-then-forward fill of zero velocities along time
    (src/data/data.py:362-389): a zero velocity takes the next nonzero one,
    else the last nonzero one before it.  Shape ``(t, N, 2)``."""
    nonzero = _norm(velocity, keepdim=True) > 0
    filled = torch.empty_like(velocity)
    carry = torch.zeros_like(velocity[0])
    for t in reversed(range(velocity.shape[0])):
        carry = torch.where(nonzero[t], velocity[t], carry)
        filled[t] = carry
    nonzero2 = _norm(filled, keepdim=True) > 0
    out = torch.empty_like(velocity)
    carry = torch.zeros_like(velocity[0])
    for t in range(velocity.shape[0]):
        carry = torch.where(nonzero2[t], filled[t], carry)
        out[t] = carry
    return out


def heading_direction(velocity: torch.Tensor,
                      time_axis: bool = True) -> torch.Tensor:
    """Normalized heading, with the temporal zero-velocity fill for a
    rank-3 ``(t, N, 2)`` input and for each channel of a rank-4
    ``(c, t, N, 2)`` one; zero vectors stay zero
    (src/data/data.py:391-394)."""
    if time_axis and velocity.ndim == 3:
        velocity = _fill_zero_velocity(velocity)
    elif time_axis and velocity.ndim == 4:
        # the fill is per (channel, agent): fill along t with the channel
        # axis carried beside the agents
        velocity = _fill_zero_velocity(
            velocity.transpose(0, 1)).transpose(0, 1)
    norm = _norm(velocity, keepdim=True)
    denom = torch.where(norm == 0, 0.1, norm)
    return velocity / denom


# ----------------------------------------------------------------------------
# neighbour selection
# ----------------------------------------------------------------------------

def nearby_in_sight(
    position: torch.Tensor,
    objects: torch.Tensor,
    heading: torch.Tensor,
    k: int,
    angle_threshold: float,
    same_objects: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distances/indices of the k closest in-view objects, ``(..., N, k)``.

    Matmul expansion as in the JAX package: ``|p_j − p_i|² = |p_i|² +
    |p_j|² − 2·p_i·p_j`` and ``(p_j − p_i)·h_i = p_j·h_i − p_i·h_i``, so
    the ``(..., N, M, 2)`` relative tensor never exists.  Ties go to the
    lowest index (stable sort); out-of-view / absent entries carry +inf.
    """
    pos = _nan_to_zero(position)
    obj = _nan_to_zero(objects)
    absent_p = torch.isnan(position).any(dim=-1)
    absent_o = torch.isnan(objects).any(dim=-1)

    p_sq = torch.sum(pos * pos, dim=-1)
    o_sq = torch.sum(obj * obj, dim=-1)
    dot = pos @ obj.transpose(-1, -2)
    dist2 = p_sq[..., :, None] + o_sq[..., None, :] - 2.0 * dot
    dist = torch.sqrt(torch.clamp_min(dist2, 0.0))
    invalid = absent_p[..., :, None] | absent_o[..., None, :]
    dist = torch.where(invalid, INF, dist)

    rel_dot_h = (heading @ obj.transpose(-1, -2)
                 - torch.sum(pos * heading, dim=-1)[..., :, None])
    h_norm = torch.clamp_min(_norm(heading), 1e-8)
    cos = rel_dot_h / torch.clamp_min(dist, 1e-8) / h_norm[..., :, None]
    cos = torch.where(invalid | torch.isnan(cos), -1.0, cos)

    if same_objects:
        n, m = position.shape[-2], objects.shape[-2]
        diag = torch.eye(n, m, dtype=torch.bool, device=position.device)
        pin = diag & ~invalid
        dist = torch.where(pin, 0.0, dist)
        cos = torch.where(pin, 0.0, cos)

    dist = torch.where(cos < pairwise.cos_threshold(angle_threshold), INF,
                       dist)
    # min(k, M) columns, as the reference's sort + [:k]
    k = min(k, objects.shape[-2])
    d, idx = torch.sort(dist, dim=-1, stable=True)
    return d[..., :k], idx[..., :k]


def gather_filtered(features: torch.Tensor, idx: torch.Tensor,
                    dist: torch.Tensor, dist_threshold: float
                    ) -> torch.Tensor:
    """``(..., N, M, d)`` rows at ``idx (..., N, k)``, zeroed beyond the
    distance threshold and where non-finite (src/data/data.py:449-464)."""
    index = idx[..., None].expand(idx.shape + features.shape[-1:])
    gathered = torch.gather(features, -2, index)
    keep = (dist <= dist_threshold)[..., None]
    gathered = torch.where(keep, gathered, 0.0)
    return torch.where(torch.isfinite(gathered), gathered, 0.0)


def _gather_neighbor_rows(table: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """``(..., M, d)[(..., N, k)] → (..., N, k, d)`` row gather."""
    if table.ndim == 2:
        return table[idx]
    lead = torch.arange(table.shape[0], device=table.device)
    return table[lead[:, None, None], idx]


def _lane_padded(m: int) -> int:
    """The object count the JAX package's size gates read (its tables are
    padded to a multiple of 128); kept so both packages route alike."""
    return max(128, -(-m // 128) * 128)


def prepare_obstacle_index(n_agents: int, obstacles: torch.Tensor,
                           cfg: NeighborConfig):
    """The banded selector's obstacle index, built once per rollout for the
    static obstacle table; None when the banded obstacle pass would not
    engage for these shapes (safe to pass to :func:`relative_features`
    either way)."""
    m = obstacles.shape[0]
    engaged = (
        cfg.use_grid_topk
        and n_agents * _lane_padded(n_agents) >= _GATE
        and n_agents * _lane_padded(m) >= _GATE
        and (_on_card(obstacles) or not cfg.use_pallas_topk)
    )
    if not engaged:
        return None
    k_obs = min(cfg.topk_obs, m)
    g_o, w_o = _obstacle_params(n_agents, m, k_obs)
    return banded.build_object_index(obstacles, g_o, w_o)


def _banded_wide_fallback(position: torch.Tensor, heading: torch.Tensor,
                          k: int, sight_angle: float, dist_threshold: float
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The agent pass's fallback past ``DENSE_COLUMN_CEILING``: K2 again
    on a grid of half the resolution (piml_tpu/physics/features.py:269).

    Halving the grid doubles the cell size, every row's distance-to-box
    bound and the tiles' windows (uniform 524k / 1M scenes overflow the
    fine grid's windows on a few tiles, 2 of 8,192 at 1,048,576 agents,
    and fit the half grid's).  The result is used whatever the exactness
    flag says, as in the JAX package, whose dense pass cannot run at this
    scale (K1 could, at 10^12 pairs a frame): a row past even the doubled
    bound keeps its 5x5 half-grid box (9x9 fine cells).
    ``KERNEL.wide_calls`` counts the calls, ``wide_relaxed`` those whose
    flag was false (one host read each).

    A standing difference: above ~10k columns the JAX package shrinks its
    row tile (TPU VMEM machinery, ``auto_tile_n``,
    piml_tpu/ops/banded.py:99-113), so at 1,048,576 agents its windows are
    16,256 (fine) and 32,128 (half grid) columns where the port's 128-row
    tiles give 16,384 and 32,256.  Both selections are exact wherever
    their flag says so; they can differ only on rows a pass relaxes."""
    n = position.shape[0]
    g1, _ = banded.banded_params(n, n, k, fine=True)
    g2 = max(g1 // 2, 3)
    _, w2 = banded.banded_params(n, n, k, grid_dim=g2, fine=True)
    bd, bi, exact = banded.topk_neighbors_banded(
        position, heading, k, sight_angle, dist_threshold=dist_threshold,
        grid_dim=g2, window=w2)
    banded.KERNEL.wide_calls += 1
    with annotate("sync.k2_exact"):
        exact = bool(exact)
    if not exact:
        banded.KERNEL.wide_relaxed += 1
    return bd, bi


def _obstacle_params(n_agents: int, m: int, k_obs: int):
    """The obstacle pass's ``(grid_dim, window)``: sized, as in the JAX
    package, from the lane-padded table, so both packages bin the same
    grid and prove exactness over the same windows."""
    return banded.banded_params(n_agents, _lane_padded(m), k_obs, fine=True)


def relative_features(
    position: torch.Tensor,
    velocity: torch.Tensor,
    acceleration: torch.Tensor,
    destination: torch.Tensor,
    obstacles: torch.Tensor,
    cfg: NeighborConfig,
    heading: Optional[torch.Tensor] = None,
    obstacle_index=None,
    batched: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Neighbour / obstacle / destination features (src/data/data.py:466-512).

    Args:
      position/velocity/acceleration/destination: ``(..., N, 2)``, NaN =
        absent; obstacles: ``(M, 2)``; heading: optional precomputed
        heading (skips the fill); obstacle_index: optional
        :func:`prepare_obstacle_index` result; batched: the leading axis
        of a rank-3 input is a batch of frames (channels), not time — opt
        in to the channel-batched banded route.

    Returns ``(ped (..., N, k1, 6), obs (..., N, k2, 6), dest (..., N, 2))``.
    """
    velocity = _nan_to_zero(velocity)
    acceleration = _nan_to_zero(acceleration)
    if heading is None:
        heading = heading_direction(velocity)

    state = torch.cat([position, velocity, acceleration], dim=-1)  # ..., N, 6
    n_real = state.shape[-2]
    k_ped = min(cfg.topk_ped, n_real)
    on_card = _on_card(position)

    big_single_frame = (position.ndim == 2
                        and n_real * _lane_padded(n_real) >= _GATE)
    use_kernel = cfg.use_pallas_topk and big_single_frame and on_card
    use_banded = (cfg.use_grid_topk and big_single_frame
                  and (on_card or not cfg.use_pallas_topk))
    use_banded_batched = (batched and cfg.use_grid_topk
                          and position.ndim == 3
                          and n_real * _lane_padded(n_real) >= _GATE
                          and (on_card or not cfg.use_pallas_topk))

    def _ped_dense():
        if use_kernel:
            if _lane_padded(n_real) > DENSE_COLUMN_CEILING:
                return _banded_wide_fallback(position, heading, k_ped,
                                             cfg.sight_angle_ped,
                                             cfg.dist_threshold_ped)
            return pairwise.topk_neighbors_pallas(
                position, heading, k_ped, cfg.sight_angle_ped)
        with torch.no_grad():
            return nearby_in_sight(position, position, heading, k_ped,
                                   cfg.sight_angle_ped, same_objects=True)

    agent_order = None
    if use_banded:
        g_p, w_p = banded.banded_params(n_real, n_real, k_ped, fine=True)
        ped_index = banded.build_object_index(position, g_p, w_p)
        inv = torch.empty_like(ped_index.order)
        inv[ped_index.order] = torch.arange(n_real, device=position.device)
        # one spatially coherent agent sort, shared with the obstacle pass
        agent_order = (ped_index.order, inv)
        ped_dist, ped_idx = banded.topk_neighbors_banded_or_dense(
            position, heading, k_ped, cfg.sight_angle_ped, _ped_dense,
            dist_threshold=cfg.dist_threshold_ped, grid_dim=g_p, window=w_p,
            index=ped_index, agent_order=agent_order,
        )
    elif use_banded_batched:
        g_p, w_p = banded.banded_params(n_real, n_real, k_ped, fine=True)
        ped_dist, ped_idx = banded.topk_neighbors_banded_batched_or_dense(
            position, heading, k_ped, cfg.sight_angle_ped, _ped_dense,
            dist_threshold=cfg.dist_threshold_ped, grid_dim=g_p, window=w_p)
    else:
        ped_dist, ped_idx = _ped_dense()
    gathered = _gather_neighbor_rows(state, ped_idx)
    rel = gathered - state[..., :, None, :]
    keep = (ped_dist <= cfg.dist_threshold_ped)[..., None]
    ped_features = torch.where(keep & torch.isfinite(rel), rel, 0.0)

    dest_features = _nan_to_zero(destination - position)

    m_real = obstacles.shape[0]
    k_obs = min(cfg.topk_obs, m_real)
    obs = obstacles.expand(position.shape[:-2] + obstacles.shape)
    big_obs = (position.shape[0] * _lane_padded(m_real) >= _GATE)

    def _obs_dense():
        if use_kernel and big_obs:
            return pairwise.topk_neighbors_pallas(
                position, heading, k_obs, cfg.sight_angle_obs,
                objects=obstacles, same_objects=False)
        with torch.no_grad():
            return nearby_in_sight(position, obs, heading, k_obs,
                                   cfg.sight_angle_obs)

    if use_banded and big_obs:
        g_o, w_o = _obstacle_params(n_real, m_real, k_obs)
        o_index = (obstacle_index if obstacle_index is not None
                   else banded.build_object_index(obstacles, g_o, w_o))
        obs_dist, obs_idx = banded.topk_neighbors_banded_or_dense(
            position, heading, k_obs, cfg.sight_angle_obs, _obs_dense,
            objects=obstacles, same_objects=False,
            dist_threshold=cfg.dist_threshold_obs, grid_dim=g_o, window=w_o,
            index=o_index, agent_order=agent_order,
        )
    elif use_banded_batched and n_real * _lane_padded(m_real) >= _GATE:
        g_o, w_o = _obstacle_params(n_real, m_real, k_obs)
        # the obstacle table is shared by the channels: one index
        obs_dist, obs_idx = banded.topk_neighbors_banded_batched_or_dense(
            position, heading, k_obs, cfg.sight_angle_obs, _obs_dense,
            objects=obstacles, dist_threshold=cfg.dist_threshold_obs,
            grid_dim=g_o, window=w_o, index=obstacle_index)
    else:
        obs_dist, obs_idx = _obs_dense()
    obs_state = torch.cat([obs, torch.zeros_like(obs), torch.zeros_like(obs)],
                          dim=-1)
    gathered_o = _gather_neighbor_rows(obs_state, obs_idx)
    rel_o = gathered_o - state[..., :, None, :]
    keep_o = (obs_dist <= cfg.dist_threshold_obs)[..., None]
    obs_features = torch.where(keep_o & torch.isfinite(rel_o), rel_o, 0.0)

    return ped_features, obs_features, dest_features


# ----------------------------------------------------------------------------
# collisions
# ----------------------------------------------------------------------------

def collision_label(ped_features: torch.Tensor) -> torch.Tensor:
    """Would-collide-within-1s label per neighbour edge: ten 0.1 s
    constant-relative-velocity sub-steps, any with distance in (0, 0.5)
    (src/data/data.py:514-535).  ``(..., k, 6) → (..., k)``."""
    t = torch.arange(10, dtype=ped_features.dtype,
                     device=ped_features.device) * 0.1
    rel_p = ped_features[..., None, :2]
    rel_v = ped_features[..., None, 2:4]
    future = rel_p + rel_v * t[:, None]
    d = _norm(future)
    hit = (d < 0.5) & (d != 0)
    return hit.any(dim=-1).to(ped_features.dtype)


def _contacts(position: torch.Tensor, threshold: float) -> torch.Tensor:
    """Pairwise 0/1 contacts minus self-loops, 0 where absent."""
    rel = position[..., None, :, :] - position[..., :, None, :]
    dist = _norm(rel)
    eye = torch.eye(position.shape[-2], dtype=position.dtype,
                    device=position.device)
    return torch.where(torch.isnan(dist), 0.0,
                       (dist < threshold).to(position.dtype) - eye)


def collision_detection(position: torch.Tensor, threshold: float,
                        real_position: Optional[torch.Tensor] = None,
                        friends_window: int = 4,
                        friends_frames: int = 25) -> torch.Tensor:
    """Pairwise contact tensor minus self-loops and "friends"
    (src/data/data.py:571-599): for ``(t, N, 2)`` input, pairs in contact
    more than ``friends_frames`` frames (counted on ``real_position`` when
    given); for ``(c, t, N, 2)``, pairs in contact during the first
    ``friends_window`` frames."""
    coll = _contacts(position, threshold)
    dt = position.dtype
    if real_position is not None:
        rrel = real_position[..., None, :, :] - real_position[..., :, None, :]
        rdist = _norm(rrel)
        rcoll = torch.where(torch.isnan(rdist), 0.0,
                            (rdist < threshold).to(dt))
        friends = (rcoll.sum(dim=0) <= friends_frames).to(dt)[None]
    elif position.ndim == 3:
        friends = (coll.sum(dim=0) <= friends_frames).to(dt)[None]
    else:
        early = coll[:, :friends_window].sum(dim=1)
        friends = (1.0 - (early > 0).to(dt))[:, None]
    return coll * friends


@torch.no_grad()
def collision_detection_single_frame(position: torch.Tensor,
                                     threshold: float) -> torch.Tensor:
    """Per-frame contact counts without the friends filter:
    ``(..., N, 2) → (..., N)``.

    The counts come from comparisons and carry no gradient.  They are
    taken ``chunk`` query rows at a time, so at most ``_PAIR_CHUNK`` pairs
    exist at once: the BPTT loss counts label contacts over whole
    ``(C, T, N)`` windows, whose pair tensor at dense N would not fit the
    card."""
    n = position.shape[-2]
    lead = math.prod(position.shape[:-2])
    chunk = max(1, _PAIR_CHUNK // max(lead * n, 1))
    cols = position[..., None, :, :]
    counts = []
    for s in range(0, max(n, 1), chunk):
        rows = position[..., s:s + chunk, None, :]
        dist = _norm(cols - rows)                          # ..., r, N
        eye = (torch.arange(s, s + dist.shape[-2], device=position.device
                            )[:, None]
               == torch.arange(n, device=position.device)[None, :])
        hit = (dist < threshold).to(position.dtype) - eye.to(position.dtype)
        counts.append(torch.where(torch.isnan(dist), 0.0, hit).sum(dim=-1))
    return torch.cat(counts, dim=-1)


# ----------------------------------------------------------------------------
# masks / windowing helpers
# ----------------------------------------------------------------------------

def move_index_matrix(mask: torch.Tensor, direction: str, n_steps: int,
                      axis: int = 0) -> torch.Tensor:
    """Shift-and-intersect of a 0/1 index matrix (src/data/data.py:674-697)."""
    zeros_shape = list(mask.shape)
    zeros_shape[axis] = n_steps
    zeros = torch.zeros(zeros_shape, dtype=mask.dtype, device=mask.device)
    length = mask.shape[axis]
    if direction == "backward":
        body = mask.narrow(axis, 0, length - n_steps)
        shifted = torch.cat([zeros, body], dim=axis)
    elif direction == "forward":
        body = mask.narrow(axis, n_steps, length - n_steps)
        shifted = torch.cat([body, zeros], dim=axis)
    else:
        raise ValueError(direction)
    return shifted * mask


def turn_detection(position: torch.Tensor, velocity: torch.Tensor,
                   mask_v: torch.Tensor) -> torch.Tensor:
    """1 for non-abnormal agents, 0 when turning (>20° between entry
    velocity and start→end chord) or loitering (mean speed < 1.3·0.3)
    (src/data/data.py:700-744).  ``(T, N, 2) → (N,)``."""
    present = torch.isfinite(position[..., 0])
    T = position.shape[0]
    any_present = present.any(dim=0)
    first = torch.argmax(present.to(torch.uint8), dim=0)
    last = T - 1 - torch.argmax(torch.flip(present, [0]).to(torch.uint8),
                                dim=0)
    idx = torch.arange(position.shape[1], device=position.device)
    ap = any_present[:, None]
    starts = torch.where(ap, position[first, idx], 1e4)
    ends = torch.where(ap, position[last, idx], 1e4)
    v_starts = torch.where(ap, velocity[first, idx], 1e4)

    chord = ends - starts
    dist = _norm(chord) + 1e-6
    norm_v = _norm(v_starts) + 1e-6
    cos_theta = torch.sum(chord * v_starts, dim=-1) / dist / norm_v
    non_abnormal = ((cos_theta >= math.cos(3.1415 * 20 / 180))
                    & (cos_theta > 0)).to(position.dtype)

    speed = _norm(_nan_to_zero(velocity))
    mean_speed = speed.sum(dim=0) / torch.clamp_min(mask_v.sum(dim=0), 1e-6)
    return torch.where(mean_speed < 1.3 * 0.3, 0.0, non_abnormal)


def desired_speed(velocity: torch.Tensor, skip_frames: int) -> torch.Tensor:
    """Mean speed over the first ``skip_frames`` frames after each agent's
    first movement, the window clipped at T (src/data/data.py:797-808).
    ``(T, N, 2) → (N,)``."""
    T = velocity.shape[0]
    speed = _norm(velocity)
    moving = speed > 0
    start = torch.where(moving.any(dim=0),
                        torch.argmax(moving.to(torch.uint8), dim=0), 0)
    offsets = torch.arange(skip_frames, device=velocity.device)
    idx = start[None, :] + offsets[:, None]
    valid = idx < T
    window = torch.gather(speed, 0, torch.clamp_max(idx, T - 1))
    window = torch.where(valid, window, 0.0)
    count = torch.clamp_min(valid.sum(dim=0), 1)
    return window.sum(dim=0) / count


def history_velocity(velocity: torch.Tensor,
                     num_history: int) -> torch.Tensor:
    """Trailing velocities ``(T, N, 2·h)``, oldest → newest, zero-padded at
    the start (src/data/data.py:787-795)."""
    T = velocity.shape[0]
    frames = []
    for i in range(num_history):
        shift = num_history - i - 1
        if shift == 0:
            frames.append(velocity)
        else:
            pad = torch.zeros((shift,) + velocity.shape[1:],
                              dtype=velocity.dtype, device=velocity.device)
            frames.append(torch.cat([pad, velocity[: T - shift]], dim=0))
    return torch.cat(frames, dim=-1)

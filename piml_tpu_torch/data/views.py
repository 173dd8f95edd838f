"""The dataset views of one scene: frame-keyed, pointwise and windowed.

Counterpart of ``piml_tpu/data/views.py`` (reference: src/data/data.py
``TimeIndexedPedData``, :746-863, ``PointwisePedData``, :958-1043, and
``ChanneledPedData``, :1046-1160): model inputs, labels, masks and the raw
kinematics a rollout needs, as tensors on the scene's device;
:func:`to_pointwise` flattens the predictable rows for the pretrain, and
:func:`to_channeled` cuts the window channels the BPTT finetune trains on.
With ``polar=True`` the neighbour features are rewritten into each agent's
heading-aligned polar frame (reference: data.py:866-955).  There is no
on-disk feature cache: the feature pass is rebuilt on every call.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from piml_tpu_torch.config import PIMLConfig
from piml_tpu_torch.physics import (
    NeighborConfig,
    collision_label,
    desired_speed as calc_desired_speed,
    heading_direction,
    history_velocity,
    move_index_matrix,
    relative_features,
    turn_detection,
)
from piml_tpu_torch.physics import polar as polar_mod
from piml_tpu_torch.scene import Scene

# Per-chunk budget of (frame, agent, object) pair elements in the feature
# pass.  Eager PyTorch materializes every (chunk, N, M) temporary that XLA
# would fuse, so the budget is far below the JAX package's 2.5e8.
_PAIR_BUDGET = 2 ** 25


def neighbor_config(cfg: PIMLConfig) -> NeighborConfig:
    return NeighborConfig(
        topk_ped=cfg.topk_ped,
        topk_obs=cfg.topk_obs,
        sight_angle_ped=cfg.sight_angle_ped,
        sight_angle_obs=cfg.sight_angle_obs,
        dist_threshold_ped=cfg.dist_threshold_ped,
        dist_threshold_obs=cfg.dist_threshold_obs,
    )


@dataclasses.dataclass
class TimeIndexedData:
    """Frame-keyed supervised view + the kinematics needed for rollout."""

    ped_features: torch.Tensor    # (T, N, k1, 6)
    obs_features: torch.Tensor    # (T, N, k2, 6)
    self_features: torch.Tensor   # (T, N, 2 + 2h + 2 + 1)
    labels: torch.Tensor          # (T, N, 6 + k1) = [p, v, a, coll-labels]
    mask_p: torch.Tensor
    mask_v: torch.Tensor
    mask_a: torch.Tensor
    mask_p_pred: torch.Tensor
    mask_v_pred: torch.Tensor
    mask_a_pred: torch.Tensor
    abnormal_mask: torch.Tensor   # (N,)
    position: torch.Tensor
    velocity: torch.Tensor
    acceleration: torch.Tensor
    destination: torch.Tensor
    dest_idx: torch.Tensor
    dest_num: torch.Tensor
    waypoints: torch.Tensor
    obstacles: torch.Tensor
    desired_speed: torch.Tensor   # (N,)
    meta_data: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def num_frames(self) -> int:
        return self.ped_features.shape[-4]

    @property
    def num_pedestrians(self) -> int:
        return self.ped_features.shape[-3]

    @property
    def time_unit(self) -> float:
        return float(self.meta_data["time_unit"])

    @property
    def feature_dims(self):
        return (self.ped_features.shape[-1], self.obs_features.shape[-1],
                self.self_features.shape[-1])


def _relative_features_chunked(scene: Scene, ncfg: NeighborConfig,
                               time_chunk: int):
    """The feature pass, ``time_chunk`` frames at a time so large scenes
    never materialize all frames' pair tensors at once.  The heading fill
    runs over the whole trajectory first (it crosses chunk boundaries)."""
    heading = heading_direction(
        torch.where(torch.isnan(scene.velocity), 0.0, scene.velocity))
    T = scene.num_steps
    if time_chunk <= 0 or T <= time_chunk:
        return relative_features(
            scene.position, scene.velocity, scene.acceleration,
            scene.destination, scene.obstacles, ncfg, heading=heading)
    outs = [
        relative_features(
            scene.position[s:s + time_chunk],
            scene.velocity[s:s + time_chunk],
            scene.acceleration[s:s + time_chunk],
            scene.destination[s:s + time_chunk], scene.obstacles, ncfg,
            heading=heading[s:s + time_chunk])
        for s in range(0, T, time_chunk)
    ]
    return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))


@torch.no_grad()
def make_time_indexed(cfg: PIMLConfig, scene: Scene, polar: bool = False,
                      time_chunk: int = 0) -> TimeIndexedData:
    """Build the supervised frame-keyed view (reference: data.py:746-834),
    with ``polar`` the polar variant (data.py:866-955: the collision
    labels are taken before the rewrite).  ``time_chunk = 0`` picks a
    chunk that keeps the per-chunk pair work near ``_PAIR_BUDGET``
    elements.  Runs without autograd, not in inference mode: the
    finetune's graph saves these tensors."""
    ncfg = neighbor_config(cfg)
    if time_chunk == 0:
        m = max(scene.num_pedestrians, int(scene.obstacles.shape[0]), 128)
        work = scene.num_pedestrians * m
        if scene.num_steps * work > _PAIR_BUDGET:
            time_chunk = max(1, int(_PAIR_BUDGET // work))
    ped_f, obs_f, dest_f = _relative_features_chunked(scene, ncfg, time_chunk)

    hist_v = history_velocity(scene.velocity, cfg.num_history_velocity)
    ds = calc_desired_speed(scene.velocity, cfg.skip_frames)    # (N,)
    T, N = scene.num_steps, scene.num_pedestrians
    ds_col = ds[None, :, None].expand(T, N, 1)
    self_f = torch.cat([dest_f, hist_v, scene.acceleration, ds_col], dim=-1)

    labels = torch.cat([scene.position, scene.velocity, scene.acceleration,
                        collision_label(ped_f)], dim=-1)
    if polar:
        heading = heading_direction(self_f[..., -5:-3])
        ped_f = polar_mod.features_to_polar(ped_f, heading)
        if obs_f.shape[-1] > 0:
            obs_f = polar_mod.features_to_polar(obs_f, heading)
    abnormal = turn_detection(scene.position, scene.velocity, scene.mask_v)

    skip = cfg.skip_frames
    mask_a_pred = move_index_matrix(scene.mask_a, "backward", skip - 1)
    mask_v_pred = move_index_matrix(scene.mask_v, "backward", skip - 1)
    mask_p_pred = move_index_matrix(scene.mask_p, "backward", skip - 1)
    mask_a_pred = move_index_matrix(mask_a_pred, "forward", 1)

    return TimeIndexedData(
        ped_features=ped_f, obs_features=obs_f, self_features=self_f,
        labels=labels,
        mask_p=scene.mask_p, mask_v=scene.mask_v, mask_a=scene.mask_a,
        mask_p_pred=mask_p_pred, mask_v_pred=mask_v_pred,
        mask_a_pred=mask_a_pred, abnormal_mask=abnormal,
        position=scene.position, velocity=scene.velocity,
        acceleration=scene.acceleration, destination=scene.destination,
        dest_idx=scene.dest_idx, dest_num=scene.dest_num,
        waypoints=scene.waypoints, obstacles=scene.obstacles,
        desired_speed=ds, meta_data=scene.meta_data,
    )


# the fields with a leading frame axis; they gain the leading window-channel
# axis in the windowed view, and the others (abnormal_mask, dest_num,
# waypoints, obstacles, desired_speed) are per-scene constants
T_KEYED = (
    "ped_features", "obs_features", "self_features", "labels",
    "mask_p", "mask_v", "mask_a", "mask_p_pred", "mask_v_pred",
    "mask_a_pred", "position", "velocity", "acceleration", "destination",
    "dest_idx",
)


def slice_frames(data: TimeIndexedData, start: int,
                 stop: int) -> TimeIndexedData:
    """The frames [start, stop) of a time-indexed view (reference:
    ``TimeIndexedPedData(*self.dataset[test_idx])``, dataset.py:248)."""
    return dataclasses.replace(
        data, **{k: getattr(data, k)[start:stop] for k in T_KEYED})


def pad_agents(data: TimeIndexedData, multiple: int) -> TimeIndexedData:
    """Pad the agent axis to a multiple of ``multiple`` with inert slots:
    NaN positions (never spawned, never selected as neighbours), zero
    masks, so every metric and loss is unchanged."""
    n = data.num_pedestrians
    extra = -n % multiple
    if extra == 0:
        return data

    def pad(x, axis, value):
        shape = list(x.shape)
        shape[axis] = extra
        return torch.cat([x, torch.full(shape, value, dtype=x.dtype,
                                        device=x.device)], dim=axis)

    return TimeIndexedData(
        ped_features=pad(data.ped_features, -3, 0.0),
        obs_features=pad(data.obs_features, -3, 0.0),
        self_features=pad(data.self_features, -2, 0.0),
        labels=pad(data.labels, -2, 0.0),
        mask_p=pad(data.mask_p, -1, 0.0),
        mask_v=pad(data.mask_v, -1, 0.0),
        mask_a=pad(data.mask_a, -1, 0.0),
        mask_p_pred=pad(data.mask_p_pred, -1, 0.0),
        mask_v_pred=pad(data.mask_v_pred, -1, 0.0),
        mask_a_pred=pad(data.mask_a_pred, -1, 0.0),
        abnormal_mask=pad(data.abnormal_mask, -1, 1.0),
        position=pad(data.position, -2, math.nan),
        velocity=pad(data.velocity, -2, 0.0),
        acceleration=pad(data.acceleration, -2, 0.0),
        destination=pad(data.destination, -2, math.nan),
        dest_idx=pad(data.dest_idx, -1, 0),
        dest_num=pad(data.dest_num, -1, 1),
        waypoints=pad(data.waypoints, -2, math.nan),
        obstacles=data.obstacles,
        desired_speed=pad(data.desired_speed, -1, 0.0),
        meta_data=data.meta_data,
    )


# ---------------------------------------------------------------------------
# pointwise view
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PointwiseData:
    """Flattened single-step training rows (reference: data.py:958-1043)."""

    ped_features: torch.Tensor    # (R, k1, 6)
    obs_features: torch.Tensor    # (R, k2, 6)
    self_features: torch.Tensor   # (R, d)
    labels: torch.Tensor          # (R, 6 + k1): next-step [p, v, a, coll]
    meta_data: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        return self.labels.shape[0]

    @property
    def time_unit(self) -> float:
        return float(self.meta_data["time_unit"])


def to_pointwise(data: TimeIndexedData,
                 frames: Optional[Sequence[int]] = None) -> PointwiseData:
    """The predictable rows (``mask_a_pred``) with labels shifted one step
    forward (reference: data.py:1007-1038).  The row filter is decided on
    the host, as in the JAX package; the rows stay on the data's device.
    ``frames`` restricts the rows to those frame indices."""
    mask_t = data.mask_a_pred.cpu().numpy() > 0
    if frames is not None:
        keep = np.zeros(mask_t.shape[0], bool)
        keep[np.asarray(frames, int)] = True
        mask_t = mask_t & keep[:, None]
    rows = torch.from_numpy(np.nonzero(mask_t.reshape(-1))[0]).to(
        data.labels.device)
    labels = torch.cat([data.labels[1:], torch.zeros_like(data.labels[:1])])

    def flat(x):
        return x.reshape((-1,) + x.shape[2:])[rows]

    return PointwiseData(
        ped_features=flat(data.ped_features),
        obs_features=flat(data.obs_features),
        self_features=flat(data.self_features),
        labels=flat(labels), meta_data=data.meta_data)


def merge_pointwise(parts: List[PointwiseData]) -> PointwiseData:
    """Concatenate pointwise datasets (reference: data.py:994-1002)."""
    if len(parts) == 1:
        return parts[0]
    tu = parts[0].time_unit
    if any(abs(p.time_unit - tu) > 1e-9 for p in parts):
        raise ValueError("PointwiseData with different time_unit cannot be "
                         "merged")

    def cat(attr):
        return torch.cat([getattr(p, attr) for p in parts], dim=0)

    return PointwiseData(
        ped_features=cat("ped_features"), obs_features=cat("obs_features"),
        self_features=cat("self_features"), labels=cat("labels"),
        meta_data=parts[0].meta_data)


# ---------------------------------------------------------------------------
# channeled (windowed) view
# ---------------------------------------------------------------------------

def window_slice(x: torch.Tensor, stride: int, mode: str) -> torch.Tensor:
    """``(T, ...) → (C, stride, ...)`` windows (reference: data.py:1071-1091).

    - ``'slice'``: C = T − stride overlapping windows, window c = frames
      [c, c+stride);
    - ``'split'``: C = T // stride disjoint chunks.
    """
    T = x.shape[0]
    if mode == "slice":
        if T <= stride:
            raise ValueError("stride must be < #total time steps "
                             "(data.py:1100)")
        idx = (torch.arange(T - stride, device=x.device)[:, None]
               + torch.arange(stride, device=x.device)[None, :])
        return x[idx]
    if mode == "split":
        step = T // stride
        return x[: step * stride].reshape((step, stride) + x.shape[1:])
    raise NotImplementedError(mode)


@dataclasses.dataclass
class ChanneledData:
    """Windowed rollout-training view (reference: data.py:1046-1160): the
    ``T_KEYED`` carry a leading channel axis C, ``(C, t, N, ...)``."""

    ped_features: torch.Tensor    # (C, t, N, k1, 6)
    obs_features: torch.Tensor
    self_features: torch.Tensor
    labels: torch.Tensor
    mask_p: torch.Tensor
    mask_v: torch.Tensor
    mask_a: torch.Tensor
    mask_p_pred: torch.Tensor
    mask_v_pred: torch.Tensor
    mask_a_pred: torch.Tensor
    position: torch.Tensor
    velocity: torch.Tensor
    acceleration: torch.Tensor
    destination: torch.Tensor
    dest_idx: torch.Tensor
    abnormal_mask: torch.Tensor   # (N,)
    dest_num: torch.Tensor        # (N,)
    waypoints: torch.Tensor       # (D, N, 2)
    obstacles: torch.Tensor
    desired_speed: torch.Tensor   # (N,)
    meta_data: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def num_channels(self) -> int:
        return self.ped_features.shape[0]

    @property
    def num_frames(self) -> int:
        return self.ped_features.shape[1]

    @property
    def time_unit(self) -> float:
        return float(self.meta_data["time_unit"])

    def slice_channels(self, idx: Union[Sequence[int], torch.Tensor]
                       ) -> "ChanneledData":
        """The windows ``idx`` (in that order) of every channel field."""
        idx = torch.as_tensor(idx, dtype=torch.long,
                              device=self.ped_features.device)
        return dataclasses.replace(
            self, **{f: getattr(self, f)[idx] for f in T_KEYED})


def to_channeled(data: TimeIndexedData, stride: int = 25,
                 mode: str = "slice") -> ChanneledData:
    """Cut a scene's view into ``stride``-frame window channels."""
    return ChanneledData(
        **{f: window_slice(getattr(data, f), stride, mode)
           for f in T_KEYED},
        abnormal_mask=data.abnormal_mask, dest_num=data.dest_num,
        waypoints=data.waypoints, obstacles=data.obstacles,
        desired_speed=data.desired_speed, meta_data=data.meta_data)

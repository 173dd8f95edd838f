"""The frame-keyed dataset view of one scene, and its windowed view.

Counterpart of ``piml_tpu/data/views.py`` (reference: src/data/data.py
``TimeIndexedPedData``, :746-863, and ``ChanneledPedData``, :1046-1160):
model inputs, labels, masks and the raw kinematics a rollout needs, as
tensors on the scene's device; :func:`to_channeled` cuts them into the
window channels the BPTT finetune trains on.  There is no on-disk feature
cache: the feature pass is rebuilt on every call.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Union

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
def make_time_indexed(cfg: PIMLConfig, scene: Scene,
                      time_chunk: int = 0) -> TimeIndexedData:
    """Build the supervised frame-keyed view (reference: data.py:746-834).
    ``time_chunk = 0`` picks a chunk that keeps the per-chunk pair work
    near ``_PAIR_BUDGET`` elements.  Runs without autograd, not in
    inference mode: the finetune's graph saves these tensors."""
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


# the fields that gain the leading window-channel axis; the others
# (abnormal_mask, dest_num, waypoints, obstacles, desired_speed) are
# per-scene constants shared by the channels
CHANNEL_FIELDS = (
    "ped_features", "obs_features", "self_features", "labels",
    "mask_p", "mask_v", "mask_a", "mask_p_pred", "mask_v_pred",
    "mask_a_pred", "position", "velocity", "acceleration", "destination",
    "dest_idx",
)


@dataclasses.dataclass
class ChanneledData:
    """Windowed rollout-training view (reference: data.py:1046-1160): the
    ``CHANNEL_FIELDS`` carry a leading channel axis C, ``(C, t, N, ...)``."""

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
            self, **{f: getattr(self, f)[idx] for f in CHANNEL_FIELDS})


def to_channeled(data: TimeIndexedData, stride: int = 25,
                 mode: str = "slice") -> ChanneledData:
    """Cut a scene's view into ``stride``-frame window channels."""
    return ChanneledData(
        **{f: window_slice(getattr(data, f), stride, mode)
           for f in CHANNEL_FIELDS},
        abnormal_mask=data.abnormal_mask, dest_num=data.dest_num,
        waypoints=data.waypoints, obstacles=data.obstacles,
        desired_speed=data.desired_speed, meta_data=data.meta_data)

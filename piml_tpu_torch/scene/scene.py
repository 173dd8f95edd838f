"""The :class:`Scene` — fixed-capacity masked scene state as tensors.

Counterpart of ``piml_tpu/scene/scene.py``: padded ``(T, N)`` arrays with
explicit masks, NaN kept in ``position`` / ``destination`` / ``waypoints``
(the feature pipeline turns it into +inf distances and zero features).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from piml_tpu_torch.scene import codec


@dataclasses.dataclass
class Scene:
    """Dense scene state on one device.

    Shapes (T = frames, N = agent capacity, D = waypoint capacity, M =
    obstacle points):

    - ``position`` / ``velocity`` / ``acceleration`` / ``destination``: (T, N, 2)
    - ``waypoints``: (D, N, 2); ``dest_idx``: (T, N) int32; ``dest_num``: (N,) int32
    - ``obstacles``: (M, 2)
    - ``mask_p`` / ``mask_v`` / ``mask_a``: (T, N) float32 presence masks
    """

    position: torch.Tensor
    velocity: torch.Tensor
    acceleration: torch.Tensor
    destination: torch.Tensor
    waypoints: torch.Tensor
    dest_idx: torch.Tensor
    dest_num: torch.Tensor
    obstacles: torch.Tensor
    mask_p: torch.Tensor
    mask_v: torch.Tensor
    mask_a: torch.Tensor
    meta_data: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def num_steps(self) -> int:
        return self.position.shape[0]

    @property
    def num_pedestrians(self) -> int:
        return self.position.shape[1]

    @property
    def time_unit(self) -> float:
        return float(self.meta_data["time_unit"])

    @classmethod
    def load(cls, path: str,
             device: Union[str, torch.device] = "cuda:0") -> "Scene":
        """Load a v2.2 ``.npy`` scene file onto ``device``."""
        return cls.from_arrays(codec.decode(path), device=device)

    @classmethod
    def from_arrays(cls, d: Dict[str, Any],
                    device: Union[str, torch.device] = "cuda:0") -> "Scene":
        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        def i32(x):
            return torch.as_tensor(np.asarray(x, np.int32), device=device)

        return cls(
            position=f32(d["position"]),
            velocity=f32(d["velocity"]),
            acceleration=f32(d["acceleration"]),
            destination=f32(d["destination"]),
            waypoints=f32(d["waypoints"]),
            dest_idx=i32(d["dest_idx"]),
            dest_num=i32(d["dest_num"]),
            obstacles=f32(d["obstacles"]),
            mask_p=f32(d["mask_p"]),
            mask_v=f32(d["mask_v"]),
            mask_a=f32(d["mask_a"]),
            meta_data=dict(d["meta_data"]),
        )

    def save(self, path: str) -> None:
        """Write the scene back as a v2.2 ``.npy`` file."""
        codec.encode(path, self.meta_data, self.position.cpu().numpy(),
                     self.mask_p.cpu().numpy(), self.waypoints.cpu().numpy(),
                     self.destination.cpu().numpy(),
                     self.obstacles.cpu().numpy())

    def pad_agents(self, n_cap: int) -> "Scene":
        """The agent axis padded to ``n_cap`` with inactive slots: NaN
        positions, destinations and waypoints, zero velocities,
        accelerations, waypoint indices and masks, one waypoint each.
        Static pre-allocation in place of the reference's
        ``add_pedestrians`` growth (src/data/data.py:259-303)."""
        n = self.num_pedestrians
        if n_cap < n:
            raise ValueError(f"capacity {n_cap} < current agents {n}")
        if n_cap == n:
            return self
        dn = n_cap - n

        def pad2(x, fill):
            return torch.cat([x, x.new_full(x.shape[:-2] + (dn, x.shape[-1]),
                                            fill)], dim=-2)

        def padm(x, fill=0):
            return torch.cat([x, x.new_full(x.shape[:-1] + (dn,), fill)],
                             dim=-1)

        return dataclasses.replace(
            self,
            position=pad2(self.position, math.nan),
            velocity=pad2(self.velocity, 0.0),
            acceleration=pad2(self.acceleration, 0.0),
            destination=pad2(self.destination, math.nan),
            waypoints=pad2(self.waypoints, math.nan),
            dest_idx=padm(self.dest_idx, 0),
            dest_num=padm(self.dest_num, 1),
            mask_p=padm(self.mask_p),
            mask_v=padm(self.mask_v),
            mask_a=padm(self.mask_a),
        )

    def pad_time(self, t_cap: int) -> "Scene":
        """The time axis padded to ``t_cap`` frames in which nobody is
        present: NaN positions and destinations, zero velocities,
        accelerations, waypoint indices and masks."""
        t = self.num_steps
        if t_cap < t:
            raise ValueError(f"capacity {t_cap} < current steps {t}")
        if t_cap == t:
            return self

        def padt(x, fill):
            return torch.cat([x, x.new_full((t_cap - t,) + x.shape[1:],
                                            fill)], dim=0)

        return dataclasses.replace(
            self,
            position=padt(self.position, math.nan),
            velocity=padt(self.velocity, 0.0),
            acceleration=padt(self.acceleration, 0.0),
            destination=padt(self.destination, math.nan),
            dest_idx=padt(self.dest_idx, 0),
            mask_p=padt(self.mask_p, 0.0),
            mask_v=padt(self.mask_v, 0.0),
            mask_a=padt(self.mask_a, 0.0),
        )


def crop(scene: Scene, start: int, stop: int,
         agents: Optional[Sequence[int]] = None) -> Scene:
    """Frames ``[start, stop)`` as a scene of their own, on the scene's
    device: the agents present in them (of ``agents``, when given), each
    with its frames in the window and the waypoints it follows there, from
    the one active at its first frame.  Built as a v2.2 file would decode
    (finite differences end at the window's last frame), so
    :meth:`Scene.save` writes it back losslessly."""
    pos = scene.position[start:stop].cpu().numpy()
    mask = scene.mask_p[start:stop].cpu().numpy() == 1
    dest_idx = scene.dest_idx[start:stop].cpu().numpy()
    waypoints = scene.waypoints.cpu().numpy()
    ids = range(scene.num_pedestrians) if agents is None else agents
    trajectories, destinations = [], []
    for i in ids:
        frames = np.nonzero(mask[:, i])[0]
        if frames.size == 0:
            continue
        trajectories.append([(float(pos[f, i, 0]), float(pos[f, i, 1]),
                              int(f)) for f in frames])
        relays = dest_idx[frames, i]
        destinations.append([
            (float(waypoints[j, i, 0]), float(waypoints[j, i, 1]),
             int(frames[np.argmax(relays == j)]))
            for j in range(int(relays[0]), int(relays.max()) + 1)])
    d = codec.decode_arrays(dict(scene.meta_data), trajectories,
                            destinations, scene.obstacles.cpu().numpy())
    return Scene.from_arrays(d, device=scene.position.device)


def rotate(scene: Scene, theta_deg: float) -> Scene:
    """Rotation augmentation (reference:
    src/utils/data_augmentation.py:11-40)."""
    th = math.radians(theta_deg)
    return _linear_map(scene, [[math.cos(th), -math.sin(th)],
                               [math.sin(th), math.cos(th)]])


def mirror(scene: Scene, theta_deg: float) -> Scene:
    """Mirror augmentation about the line at ``theta_deg`` (reference:
    src/utils/data_augmentation.py:42-69)."""
    th = math.radians(theta_deg)
    return _linear_map(scene, [[math.cos(2 * th), math.sin(2 * th)],
                               [math.sin(2 * th), -math.cos(2 * th)]])


def _linear_map(scene: Scene, mat) -> Scene:
    mat = torch.tensor(mat, dtype=torch.float32,
                       device=scene.position.device)

    def ap(x):
        return torch.einsum("ij,...j->...i", mat, x)

    return dataclasses.replace(
        scene,
        position=ap(scene.position),
        velocity=ap(scene.velocity),
        acceleration=ap(scene.acceleration),
        destination=ap(scene.destination),
        waypoints=ap(scene.waypoints),
        obstacles=(ap(scene.obstacles) if scene.obstacles.numel()
                   else scene.obstacles),
    )


def random_walk_noise(generator: torch.Generator, velocity: torch.Tensor,
                      mask_v: torch.Tensor,
                      noise_std_last_step: float) -> torch.Tensor:
    """GNS-style cumulative velocity noise (reference:
    src/functions/noises.py:9-19): per-frame steps of std
    ``noise_std_last_step / sqrt(T)`` on present frames, summed over time,
    zero where ``mask_v == 0``.  The steps are drawn from ``generator`` on
    its own device, so a seed gives the same noise on every device."""
    t = velocity.shape[0]
    noise = torch.randn(velocity.shape, generator=generator,
                        device=generator.device).to(velocity.device)
    noise = noise * (noise_std_last_step / t ** 0.5)
    noise = noise * mask_v[..., None]
    noise = torch.cumsum(noise, dim=0)
    return noise * mask_v[..., None]

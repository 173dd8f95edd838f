"""The :class:`Scene` — fixed-capacity masked scene state as tensors.

Counterpart of ``piml_tpu/scene/scene.py``: padded ``(T, N)`` arrays with
explicit masks, NaN kept in ``position`` / ``destination`` / ``waypoints``
(the feature pipeline turns it into +inf distances and zero features).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Union

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
             device: Union[str, torch.device] = "cpu") -> "Scene":
        """Load a v2.2 ``.npy`` scene file onto ``device``."""
        return cls.from_arrays(codec.decode(path), device=device)

    @classmethod
    def from_arrays(cls, d: Dict[str, Any],
                    device: Union[str, torch.device] = "cpu") -> "Scene":
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

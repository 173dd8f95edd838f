"""Scene file codec for the "v2.2" ``.npy`` format.

File layout (reference: src/data/data.py:96-98, README.md:44-53): a pickled
object array ``(meta_data, trajectories, destinations, obstacles)`` where

- ``meta_data``: dict with at least ``time_unit`` and ``version == 'v2.2'``;
- ``trajectories``: list over pedestrians of lists of ``(x, y, t)`` tuples with
  consecutive integer frames ``t``;
- ``destinations``: list over pedestrians of lists of waypoints ``(x, y, t)``,
  ``t`` being the frame at which the waypoint becomes the active destination;
- ``obstacles``: ``(M, 2)`` array of obstacle sample points (may be empty).

Decoding densifies into ``(T, N, ...)`` arrays with NaN marking out-of-frame
agents, finite-difference velocity/acceleration
(``v[t] = (p[t+1]-p[t]) / dt``, reference: src/data/data.py:149-156), and the
reference's mask conventions: ``mask_p`` is 1 for every present frame,
``mask_v``/``mask_a`` drop the final one/two frames of each trajectory
(src/data/data.py:115-124).  Missing obstacles are replaced with the far-away
dummy pair (src/data/data.py:101-103).

This is a pure-numpy module (no JAX) so it can run in data-loading processes.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

DUMMY_OBSTACLES = np.array([[1e4, 1e4], [1e4 + 1.0, 1e4 + 1.0]], dtype=np.float32)
VERSION = "v2.2"


class SceneFormatError(ValueError):
    pass


def decode(path: str) -> Dict[str, np.ndarray]:
    """Load a v2.2 scene file into dense arrays.

    Returns a dict with keys: meta_data, position, velocity, acceleration,
    destination, waypoints, dest_idx, dest_num, obstacles, mask_p, mask_v,
    mask_a (all numpy; position/destination/waypoints carry NaN for
    out-of-frame entries exactly as the reference does).
    """
    raw = np.load(path, allow_pickle=True)
    meta_data, trajectories, destinations, obstacles = raw
    if not (isinstance(meta_data, dict) and meta_data.get("version") == VERSION):
        raise SceneFormatError(f"'{path}' is not a v2.2 scene file")
    return decode_arrays(meta_data, trajectories, destinations, obstacles)


def decode_arrays(meta_data: dict, trajectories: Sequence, destinations: Sequence,
                  obstacles) -> Dict[str, np.ndarray]:
    obstacles = np.asarray(obstacles, dtype=np.float32)
    if obstacles.size == 0:
        obstacles = DUMMY_OBSTACLES.copy()
    obstacles = obstacles.reshape(-1, 2)

    dt = float(meta_data["time_unit"])
    num_steps = int(max(traj[-1][-1] for traj in trajectories)) + 1
    num_peds = len(trajectories)
    num_dests = int(max(len(d) for d in destinations))

    position = np.zeros((num_steps, num_peds, 2), dtype=np.float32)
    mask_p = np.zeros((num_steps, num_peds), dtype=np.float32)
    mask_v = np.zeros((num_steps, num_peds), dtype=np.float32)
    mask_a = np.zeros((num_steps, num_peds), dtype=np.float32)

    # Densify trajectories — vectorized per pedestrian (the reference
    # uses a per-point Python loop, src/data/data.py:115-124).
    for i, traj in enumerate(trajectories):
        arr = np.asarray(traj, dtype=np.float64)
        ts = arr[:, 2].astype(np.int64)
        position[ts, i, :] = arr[:, :2]
        mask_p[ts, i] = 1.0
        mask_v[ts, i] = 1.0
        mask_a[ts, i] = 1.0
        t_last = ts[-1]
        # last frame has no forward difference; second-to-last has no acc
        mask_v[t_last, i] = 0.0
        mask_a[t_last, i] = 0.0
        if t_last >= 1:
            mask_a[t_last - 1, i] = 0.0

    if np.isnan(position[mask_p == 1]).any():
        raise SceneFormatError("raw scene data must not contain NaN values")

    # Destinations / waypoints
    destination = np.zeros((num_steps, num_peds, 2), dtype=np.float32)
    waypoints = np.full((num_dests, num_peds, 2), np.nan, dtype=np.float32)
    dest_idx = np.zeros((num_steps, num_peds), dtype=np.int64)
    dest_num = np.array([len(d) for d in destinations], dtype=np.int64)

    for i, relays in enumerate(destinations):
        arr = np.asarray(relays, dtype=np.float64)
        d = arr[:, :2]
        t = arr[:, 2].astype(np.int64)
        waypoints[: d.shape[0], i, :] = d
        j = -1
        for j in range(d.shape[0] - 1):
            destination[t[j]: t[j + 1], i, :] = d[j]
            dest_idx[t[j]: t[j + 1], i] = j
        destination[t[j + 1]:, i, :] = d[j + 1]
        dest_idx[t[j + 1]:, i] = j + 1

    absent = mask_p == 0
    destination[absent] = np.nan
    position[absent] = np.nan

    # Finite differences with last-frame duplication (data.py:149-156)
    velocity = (np.concatenate([position[1:], position[-1:]], axis=0)
                - position) / dt
    velocity[mask_v == 0] = 0.0
    acceleration = (np.concatenate([velocity[1:], velocity[-1:]], axis=0)
                    - velocity) / dt
    acceleration[mask_a == 0] = 0.0

    if np.isnan(velocity).any() or np.isnan(acceleration).any():
        raise SceneFormatError("NaN leaked into velocity/acceleration")

    return dict(
        meta_data=dict(meta_data),
        position=position,
        velocity=velocity.astype(np.float32),
        acceleration=acceleration.astype(np.float32),
        destination=destination,
        waypoints=waypoints,
        dest_idx=dest_idx,
        dest_num=dest_num,
        obstacles=obstacles,
        mask_p=mask_p,
        mask_v=mask_v,
        mask_a=mask_a,
    )


def encode(path: str, meta_data: dict, position: np.ndarray, mask_p: np.ndarray,
           waypoints: np.ndarray, destination: np.ndarray,
           obstacles: np.ndarray) -> None:
    """Write dense arrays back to a v2.2 scene file.

    Inverse of :func:`decode` — reconstructs sparse trajectories from the
    presence mask and waypoint activation times from the dense destination
    track (reference: src/data/data.py:305-340).
    """
    meta = dict(meta_data)
    meta["version"] = VERSION
    T, N, _ = position.shape

    trajectories: List[List[Tuple[float, float, int]]] = []
    for n in range(N):
        frames = np.nonzero(mask_p[:, n] == 1)[0]
        trajectories.append(
            [(float(position[f, n, 0]), float(position[f, n, 1]), int(f))
             for f in frames]
        )

    destinations: List[List[Tuple[float, float, int]]] = []
    frame_id = np.arange(T)
    for i in range(waypoints.shape[1]):
        relays = waypoints[:, i, :]
        dest: List[Tuple[float, float, int]] = []
        for des in relays:
            if np.isnan(des).any():
                continue
            hits = frame_id[np.linalg.norm(des[None, :] - destination[:, i, :], axis=1) < 0.01]
            if hits.size > 0:
                dest.append((float(des[0]), float(des[1]), int(hits[0])))
            else:
                break
        if dest:
            destinations.append(dest)

    data = np.array(
        (meta, trajectories, destinations, np.asarray(obstacles).tolist()), dtype=object
    )
    np.save(path, data)

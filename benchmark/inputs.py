"""The benchmark's inputs, made from ``--seed`` or read from its own files.

Everything here is the benchmark's: weights (the committed ones, read with
numpy, or seeded on the card), the dense crowds and training windows
drawn on the card with a ``torch.Generator``, and the recorded GC scene
decoded into dense tracks.  Both the program and the reference get these
same tensors; whatever either derives from them is its own.
"""

from __future__ import annotations

import math
import os
import random
from typing import Dict, List

import numpy as np
import torch

from benchmark.yardstick.model_layers import layers

HERE = os.path.dirname(os.path.abspath(__file__))


def path(rel: str) -> str:
    """A file of the benchmark, named relative to the checkout's root."""
    return os.path.join(os.path.dirname(HERE), rel)


def card_generator(seed: int, device: torch.device, stream: int) -> torch.Generator:
    """A generator on ``device`` for one named stream of a run's draws."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream) % (2 ** 63))


def host_rng(seed: int, stream: int) -> random.Random:
    return random.Random(int(seed) * 1_000_003 + stream)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def weights_from_npz(rel: str, device) -> Dict[str, torch.Tensor]:
    """A flax-named ``.npz`` (``a/b/dense_0/kernel`` of shape (in, out)) as
    ``{a.b.dense_0.weight: (out, in)}`` tensors on ``device``."""
    out = {}
    with np.load(path(rel)) as z:
        for key in z.files:
            name = key.replace("/", ".")
            arr = z[key]
            if name.endswith(".kernel"):
                name, arr = name[:-len("kernel")] + "weight", arr.T
            out[name] = torch.as_tensor(np.ascontiguousarray(arr),
                                        dtype=torch.float32, device=device)
    return out


def seeded_weights(widths: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every layer's weight and bias uniform in ±1/√fan_in, drawn on the
    card in one call from the seed."""
    shapes = layers(widths)
    total = sum(o * i + o for _, i, o, _ in shapes)
    flat = torch.rand(total, generator=card_generator(seed, device, 1),
                      device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, i, o, _ in shapes:
        bound = 1.0 / math.sqrt(i)
        out[f"{name}.weight"] = (flat[at:at + o * i] * bound).view(o, i)
        at += o * i
        out[f"{name}.bias"] = flat[at:at + o] * bound
        at += o
    return out


def load_weights(config: dict, purpose: str, seed: int, device):
    src = config["weights"][purpose]
    if src == "seeded":
        return seeded_weights(config["widths"], seed, device)
    return weights_from_npz(src, device)


# ---------------------------------------------------------------------------
# dense crowds
# ---------------------------------------------------------------------------

def dense_crowds(tr: dict, seed: int, device) -> dict:
    """``tr["states"]`` initial crowds of ``agents`` over a square of side
    ``extent`` (uniform positions and waypoints, normal velocities), one
    shared set of ``obstacles`` points."""
    g = card_generator(seed, device, 2)
    n, s, ext = tr["agents"], tr["states"], float(tr["extent"])
    return dict(
        obstacles=torch.rand((tr["obstacles"], 2), generator=g,
                             device=device) * ext,
        pos=torch.rand((s, n, 2), generator=g, device=device) * ext,
        vel=torch.randn((s, n, 2), generator=g, device=device),
        waypoints=torch.rand((s, 1, n, 2), generator=g, device=device) * ext,
        desired_speed=torch.full((n,), float(tr["desired_speed"]),
                                 device=device),
    )


def dense_windows(tr: dict, seed: int, device) -> List[dict]:
    """``tr["batches"]`` training batches of ``windows`` × ``frames`` ×
    ``agents``: uniform positions drifting at their normal initial
    velocity, uniform waypoints, ``obstacles`` points; every agent present
    and predictable in every frame."""
    g = card_generator(seed, device, 3)
    C, T, n, ext = tr["windows"], tr["frames"], tr["agents"], float(tr["extent"])
    dt = float(tr["time_unit"])
    out = []
    for _ in range(tr["batches"]):
        pos0 = torch.rand((C, n, 2), generator=g, device=device) * ext
        vel0 = torch.randn((C, n, 2), generator=g, device=device)
        wp = torch.rand((1, n, 2), generator=g, device=device) * ext
        obstacles = torch.rand((tr["obstacles"], 2), generator=g,
                               device=device) * ext
        drift = torch.arange(T, device=device, dtype=torch.float32) * dt
        pos = pos0[:, None] + vel0[:, None] * drift[None, :, None, None]
        out.append(dict(
            position=pos, velocity=vel0[:, None].expand(C, T, n, 2),
            acceleration=torch.zeros((C, T, n, 2), device=device),
            destination=wp[0].expand(C, T, n, 2),
            dest_idx=torch.zeros((C, T, n), dtype=torch.int32, device=device),
            mask_p=torch.ones((C, T, n), device=device),
            mask_p_pred=torch.ones((C, T, n), device=device),
            labels_p=pos, waypoints=wp,
            dest_num=torch.ones(n, dtype=torch.int32, device=device),
            obstacles=obstacles,
            desired_speed=torch.full((n,), float(tr["desired_speed"]),
                                     device=device),
            abnormal_mask=torch.ones(n, device=device)))
    return out


# ---------------------------------------------------------------------------
# the recorded GC scene
# ---------------------------------------------------------------------------

DUMMY_OBSTACLES = np.array([[1e4, 1e4], [1e4 + 1.0, 1e4 + 1.0]], np.float32)


TRACKS = ("position", "velocity", "acceleration", "destination", "dest_idx",
          "mask_p", "mask_v", "mask_a")


def decode_scene(rel: str, frames=None, time_unit=None) -> dict:
    """A v2.2 scene file (a pickled ``(meta, trajectories, destinations,
    obstacles)``; trajectories and waypoints as ``(x, y, frame)`` lists)
    as dense ``(T, N, ...)`` numpy tracks: NaN where an agent is absent,
    finite-difference velocity and acceleration, presence masks (velocity
    and acceleration drop a track's last one and two frames).  ``frames``:
    ``[start, stop)`` of the tracks to keep; ``time_unit``: the frame
    interval the configuration expects of the scene."""
    out = _decode(rel)
    if time_unit is not None and float(out["meta_data"]["time_unit"]) != time_unit:
        raise ValueError(f"{rel}: the scene's time unit is not {time_unit}")
    if frames is not None:
        for k in TRACKS:
            out[k] = out[k][frames[0]:frames[1]]
    return out


def _decode(rel: str) -> dict:
    meta, trajs, dests, obstacles = np.load(path(rel), allow_pickle=True)
    obstacles = np.asarray(obstacles, np.float32)
    if obstacles.size == 0:
        obstacles = DUMMY_OBSTACLES.copy()
    obstacles = obstacles.reshape(-1, 2)
    dt = float(meta["time_unit"])
    T = int(max(tr[-1][-1] for tr in trajs)) + 1
    N = len(trajs)
    D = int(max(len(d) for d in dests))
    pos = np.zeros((T, N, 2), np.float32)
    mask_p = np.zeros((T, N), np.float32)
    mask_v = np.zeros((T, N), np.float32)
    mask_a = np.zeros((T, N), np.float32)
    for i, tr in enumerate(trajs):
        arr = np.asarray(tr, np.float64)
        ts = arr[:, 2].astype(np.int64)
        pos[ts, i] = arr[:, :2]
        mask_p[ts, i] = mask_v[ts, i] = mask_a[ts, i] = 1.0
        mask_v[ts[-1], i] = mask_a[ts[-1], i] = 0.0
        if ts[-1] >= 1:
            mask_a[ts[-1] - 1, i] = 0.0
    dest = np.zeros((T, N, 2), np.float32)
    wps = np.full((D, N, 2), np.nan, np.float32)
    dest_idx = np.zeros((T, N), np.int64)
    dest_num = np.array([len(d) for d in dests], np.int64)
    for i, relays in enumerate(dests):
        arr = np.asarray(relays, np.float64)
        d, t = arr[:, :2], arr[:, 2].astype(np.int64)
        wps[: d.shape[0], i] = d
        j = -1
        for j in range(d.shape[0] - 1):
            dest[t[j]:t[j + 1], i] = d[j]
            dest_idx[t[j]:t[j + 1], i] = j
        dest[t[j + 1]:, i] = d[j + 1]
        dest_idx[t[j + 1]:, i] = j + 1
    absent = mask_p == 0
    dest[absent] = np.nan
    pos[absent] = np.nan
    vel = (np.concatenate([pos[1:], pos[-1:]], 0) - pos) / dt
    vel[mask_v == 0] = 0.0
    acc = (np.concatenate([vel[1:], vel[-1:]], 0) - vel) / dt
    acc[mask_a == 0] = 0.0
    return dict(meta_data=dict(meta), position=pos,
                velocity=vel.astype(np.float32),
                acceleration=acc.astype(np.float32), destination=dest,
                waypoints=wps, dest_idx=dest_idx, dest_num=dest_num,
                obstacles=obstacles, mask_p=mask_p, mask_v=mask_v,
                mask_a=mask_a)


def tracks_on(arrays: dict, device) -> dict:
    """The decoded scene as tensors (f32; indices int32)."""
    out = {}
    for k, v in arrays.items():
        if k == "meta_data":
            continue
        dt = torch.int32 if v.dtype.kind == "i" else torch.float32
        out[k] = torch.as_tensor(np.asarray(v), dtype=dt, device=device)
    return out


def draw_starts(seed: int, stream: int, lo: int, hi: int, count: int) -> List[int]:
    """``count`` window starts in ``[lo, hi)`` drawn from the seed."""
    rng = host_rng(seed, stream)
    return [rng.randrange(lo, hi) for _ in range(count)]

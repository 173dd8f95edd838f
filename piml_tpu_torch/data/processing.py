"""Raw-dataset processors and baseline exporters.

A numpy copy of ``piml_tpu/data/processing.py`` on the port's ``Scene``
(the port imports nothing of the JAX package).  Reference:
src/data/data_processing/{GC,UCY}_dataset_processor.py and the
to_sgan / to_social_lstm / to_social_stgcnn exporters.  These convert raw
annotations into the v2.2 scene format and export scenes to the text formats
consumed by the external S-GAN / Social-LSTM / Social-STGCNN baselines.

Host-side numpy/scipy; the raw annotation archives themselves are not shipped
with either repository — the processors are exercised on synthetic fixtures in
the test suite.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from piml_tpu_torch.scene import Scene

# Fixed homographies, picture → world coordinates
# (reference: GC_dataset_processor.py:63-65, UCY_dataset_processor.py:53-55)
GC_HOMOGRAPHY = np.array([
    [3.54477751e-02, 1.73477252e-02, -1.82112170e+01],
    [6.03523702e-04, -5.58259424e-02, 5.12654156e+01],
    [1.00205219e-05, 1.25487966e-03, 1.00000000e+00],
])
UCY_HOMOGRAPHY = np.array([
    [2.84217540e-02, 2.97335273e-03, 6.02821031e+00],
    [-1.67162992e-03, 4.40195878e-02, 7.29109248e+00],
    [-9.83343172e-05, 5.42377797e-04, 1.00000000e+00],
])


def apply_homography(points: np.ndarray, M: np.ndarray) -> np.ndarray:
    """Projective transform of (K, 2) image points."""
    homog = np.concatenate([points, np.ones((points.shape[0], 1))], axis=1)
    world = np.einsum("ij,nj->ni", M, homog)
    return world[:, :2] / world[:, 2:3]


def interpolate_trajectory(traj: np.ndarray, sample_frames: np.ndarray,
                           kind: str = "cubic") -> np.ndarray:
    """Cubic (fallback linear) resampling of an (S, 3) [x, y, frame] track
    onto ``sample_frames`` (reference: GC processor interp1d usage)."""
    from scipy.interpolate import interp1d

    out = np.zeros((len(sample_frames), 3))
    out[:, 2] = sample_frames
    try:
        out[:, 0] = interp1d(traj[:, 2], traj[:, 0], kind=kind)(sample_frames)
        out[:, 1] = interp1d(traj[:, 2], traj[:, 1], kind=kind)(sample_frames)
    except ValueError:  # too few points for the requested order
        out[:, 0] = np.interp(sample_frames, traj[:, 2], traj[:, 0])
        out[:, 1] = np.interp(sample_frames, traj[:, 2], traj[:, 1])
    return out


def split_at_gaps(trajectories: List[List[Tuple[float, float, int]]]):
    """Split trajectories at frame gaps > 1 (reference: src/utils/data_process.py)."""
    out = []
    for traj in trajectories:
        frames = np.array([t for _, _, t in traj])
        if np.all(np.diff(frames) == 1):
            out.append(traj)
            continue
        left = 0
        for right in range(1, len(traj)):
            if frames[right] - frames[right - 1] > 1:
                out.append(traj[left:right])
                left = right
        out.append(traj[left:])
    return [t for t in out if t]


def gc_obstacle(length: float = 39, width: float = 30) -> np.ndarray:
    """The concourse's circular obstacle (GC_dataset_processor.py:118-121)."""
    R = 0.14667 * width / 2
    theta = np.linspace(0, 2 * np.pi, 100)
    return np.stack([R * np.cos(theta) + 0.45333 * width,
                     R * np.sin(theta) + 0.28974 * length], axis=1)


def process_gc(
    annotation_dir: str,
    out_path: str,
    ped_range: Tuple[int, int] = (1, 12686),
    time_range_s: Tuple[float, float] = (760, 820),
    space_range: Sequence[Sequence[float]] = ((5, 15), (25, 35)),
    interpolation: int = 9,
) -> str:
    """GC annotations (one ``{id:06d}.txt`` of image-coord triples per
    pedestrian, 25 fps video sampled every 20 frames) → v2.2 scene.

    Mirrors GC_dataset_processor.py: homography to world coordinates, cubic
    interpolation ×(interpolation+1) to Δt = 0.08 s, time/space cropping,
    gap splitting, final-position destinations, circular obstacle.
    """
    time_unit = 20 / 25 / (interpolation + 1)
    frame_range = (int(time_range_s[0] / time_unit),
                   int(time_range_s[1] / time_unit))
    meta = {
        "time_unit": time_unit, "version": "v2.2",
        "begin_frame": int(time_range_s[0] * 25),
        "interpolation": interpolation, "source": "GC dataset",
    }

    trajectories = []
    for i in range(ped_range[0], ped_range[1]):
        path = os.path.join(annotation_dir, f"{i:06d}.txt")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            vals = [int(x) for x in f.read().split() if x]
        traj = np.array(vals, float).reshape(-1, 3)
        traj[:, 2] = traj[:, 2] / 20 * (interpolation + 1)
        traj[:, :2] = apply_homography(traj[:, :2], GC_HOMOGRAPHY)

        frames = np.arange(traj[0, 2], traj[-1, 2] + 1)
        traj = interpolate_trajectory(traj, frames)
        keep = (traj[:, 2] >= frame_range[0]) & (traj[:, 2] < frame_range[1])
        traj = traj[keep]
        keep = ((traj[:, 0] >= space_range[0][0]) & (traj[:, 0] <= space_range[1][0])
                & (traj[:, 1] >= space_range[0][1]) & (traj[:, 1] <= space_range[1][1]))
        traj = traj[keep]
        if len(traj):
            trajectories.append(
                [(x, y, int(f) - frame_range[0]) for x, y, f in traj]
            )

    trajectories = split_at_gaps(trajectories)
    destinations = [[(t[-1][0], t[-1][1], t[-1][2])] for t in trajectories]
    data = np.array((meta, trajectories, destinations, gc_obstacle()),
                    dtype=object)
    np.save(out_path, data)
    return out_path


def parse_vsp(path: str) -> List[np.ndarray]:
    """Parse a UCY ``.vsp`` spline file into per-pedestrian (S, 3) arrays of
    image-coordinate control points (UCY_dataset_processor.py:70-78)."""
    tracks = []
    with open(path) as f:
        num_peds = int(f.readline().split(" ")[0])
        for _ in range(num_peds):
            s = int(f.readline().split(" ")[0])
            pts = np.zeros((s, 3))
            for j in range(s):
                pts[j] = np.array(f.readline().split(" ")[0:3], float)
            tracks.append(pts)
    return tracks


def process_ucy(
    vsp_path: str,
    out_path: str,
    time_range_s: Tuple[float, float] = (0, 54),
    time_unit: float = 1.0 / 12.5,
) -> str:
    """UCY students003 ``.vsp`` → v2.2 scene: homography, cubic resampling to
    Δt = 0.08 s, time cropping, final-position destinations, **no obstacles**
    (UCY_dataset_processor.py:103)."""
    frame_range = (time_range_s[0] * 25, time_range_s[1] * 25)
    meta = {
        "time_unit": time_unit, "version": "v2.2",
        "begin_time": time_range_s[0], "source": "UCY dataset",
    }
    trajectories = []
    for traj in parse_vsp(vsp_path):
        traj = traj.copy()
        traj[:, :2] = apply_homography(traj[:, :2], UCY_HOMOGRAPHY)
        order = np.argsort(traj[:, 2])
        traj = traj[order]
        frames = np.arange(traj[0, 2], traj[-1, 2] + 1, time_unit * 25)
        traj_i = interpolate_trajectory(traj, frames)
        pts = [(x, y, int(f / time_unit / 25)) for x, y, f in traj_i
               if frame_range[0] <= f <= frame_range[1]]
        if pts:
            trajectories.append(pts)
    destinations = [[(t[-1][0], t[-1][1], t[-1][2])] for t in trajectories]
    data = np.array((meta, trajectories, destinations, []), dtype=object)
    np.save(out_path, data)
    return out_path


# ---------------------------------------------------------------------------
# baseline exporters (reference: to_sgan.py / to_social_lstm.py / to_social_stgcnn.py)
# ---------------------------------------------------------------------------

def export_scene(scene: Scene, out_path: str, fmt: str = "sgan") -> str:
    """Write a scene as baseline-consumable text.

    - ``sgan`` / ``stgcnn``: frame-major ``frame\\tped\\tx\\ty`` rows;
    - ``social_lstm``: pedestrian-major ``frame ped y x`` rows (note the
      swapped coordinate order, to_social_lstm.py:40).
    """
    pos = scene.position.cpu().numpy()
    mask = scene.mask_p.cpu().numpy()
    T, N = mask.shape
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        if fmt in {"sgan", "stgcnn"}:
            for frame in range(T):
                for ped in range(N):
                    if mask[frame, ped] == 1:
                        f.write(f"{frame}\t{ped}\t{pos[frame, ped, 0]}\t{pos[frame, ped, 1]}\n")
        elif fmt == "social_lstm":
            for ped in range(N):
                for frame in range(T):
                    if mask[frame, ped] == 1:
                        f.write(f"{frame} {ped} {pos[frame, ped, 1]} {pos[frame, ped, 0]}\n")
        else:
            raise NotImplementedError(fmt)
    return out_path


def export_splits(split_paths: Dict[str, List[str]], out_dir: str,
                  fmt: str = "sgan",
                  device: Union[str, torch.device] = "cuda:0") -> List[str]:
    """Export train/val/test scene lists like the reference exporter mains;
    each scene is loaded onto ``device``."""
    written = []
    for split, paths in split_paths.items():
        for path in paths:
            scene = Scene.load(path, device=device)
            name = os.path.splitext(os.path.basename(path))[0]
            out = os.path.join(out_dir, split, f"{name}.txt")
            written.append(export_scene(scene, out, fmt))
    return written

"""Rollout-error analysis utilities (reference: src/utils/utils.py:102-128).

A numpy copy of ``piml_tpu/utils/analysis.py``; pass host arrays
(``tensor.cpu().numpy()``)."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def rollout_mae_powerlaw(
    label_position: np.ndarray,   # (T, N, 2)
    pred_position: np.ndarray,    # (T, N, 2)
    mask_pred: np.ndarray,        # (T, N)
    time_unit: float,
    split_s: Sequence[float] = tuple(range(0, 12, 2)),
) -> Tuple[np.ndarray, float, float]:
    """MAE bucketed by simulated-horizon (0–2–4–…s) with a power-law fit
    ``MAE = e^b · t^a``.  Returns (per-bucket MAEs, a, b).

    Only pedestrians simulated for at least ``split_s[-1]`` seconds enter the
    buckets, measured from each pedestrian's first simulated frame.
    """
    label_position = np.asarray(label_position)
    pred_position = np.asarray(pred_position)
    mask_pred = np.asarray(mask_pred)
    T, N = mask_pred.shape
    split_f = [int(t / time_unit) for t in split_s]

    begin = np.zeros(N, int)
    end = np.zeros(N, int)
    for p in range(N):
        frames = np.nonzero(mask_pred[:, p])[0]
        if frames.size:
            begin[p], end[p] = frames[0], frames[-1]
    valid = (end - begin) >= split_f[-1]

    maes = []
    for n in range(1, len(split_f)):
        bucket = np.zeros_like(mask_pred)
        for p in np.nonzero(valid)[0]:
            bucket[begin[p] + split_f[n - 1]: begin[p] + split_f[n], p] = 1
        sel = bucket == 1
        err = np.linalg.norm(label_position[sel] - pred_position[sel], axis=-1)
        maes.append(float(np.mean(err)) if err.size else np.nan)
    maes = np.array(maes)

    good = np.isfinite(maes) & (maes > 0)
    if good.sum() >= 2:
        t = np.array(split_s[1:], float)[good]
        a, b = np.polyfit(np.log(t), np.log(maes[good]), 1)
    else:
        a = b = float("nan")
    return maes, float(a), float(b)

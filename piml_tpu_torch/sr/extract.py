"""Symbolic-regression data preparation: edge messages + polar features.

Counterpart of ``piml_tpu/sr/extract.py`` (reference:
src/models/simulators.py:840-923 and the filters in
src/symbolic_regression.py:55-115).  Produces (features, labels) arrays
where

- features = ``(r, θ_r, v, θ_v, θ_r², coll_pred)`` per neighbor edge —
  heading-aligned polar relative position/velocity plus the global-frame
  angle and the 1-second collision forecast;
- labels = per-edge message: for bottleneck models the polar magnitude /
  direction of the predicted 2-D force; otherwise the two highest-variance
  message dimensions.

The JAX functions take ``(params, apply_fn, data)``; these take the model
itself, run it under ``no_grad`` with no dropout generator (deterministic,
like JAX's ``apply``) on the data's device, in ``EXTRACT_CHUNK``-row
chunks, and move to numpy only at the end.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from piml_tpu_torch.data.views import PointwiseData
from piml_tpu_torch.physics import collision_label, heading_direction
from piml_tpu_torch.physics import polar as polar_mod

# rows per model call: bounds the activations of a long scene's rows
EXTRACT_CHUNK = 1 << 16


def _ped_messages(model: torch.nn.Module, data: PointwiseData
                  ) -> torch.Tensor:
    """The model's per-edge agent messages ``(R, k, m)``."""
    return torch.cat([
        model(data.ped_features[s:s + EXTRACT_CHUNK],
              data.obs_features[s:s + EXTRACT_CHUNK],
              data.self_features[s:s + EXTRACT_CHUNK]).ped_msgs
        for s in range(0, max(len(data), 1), EXTRACT_CHUNK)])


def _x_axis(like: torch.Tensor) -> torch.Tensor:
    x = torch.zeros_like(like)
    x[:, 0] = 1.0
    return x


@torch.no_grad()
def prepare_symbolic_regression_data(
    model: torch.nn.Module, data: PointwiseData
) -> Tuple[np.ndarray, np.ndarray]:
    """(features (E, 6), labels (E, 2)) — reference simulators.py:840-896."""
    polar_base = heading_direction(data.self_features[..., -5:-3],
                                   time_axis=False)
    base_k = polar_base[..., None, :].expand(
        data.ped_features.shape[:-1] + (2,)).reshape(-1, 2)

    feats = data.ped_features.reshape(-1, data.ped_features.shape[-1])
    coll = collision_label(feats).reshape(-1, 1)

    r_thetar = polar_mod.cart_to_polar(feats[:, :2], base_k)
    v_thetav = polar_mod.cart_to_polar(feats[:, 2:4], base_k)
    # the reference zeroes both the speed and the angle column above 4.5
    v_thetav = torch.where(v_thetav > 4.5, 0.0, v_thetav)
    theta_r2 = polar_mod.cart_to_polar(feats[:, :2],
                                       _x_axis(base_k))[..., 1:2] + 3.1415926
    theta_r2 = torch.where(theta_r2 > 3.1415926, theta_r2 - 2 * 3.1415926,
                           theta_r2)
    features = torch.cat([r_thetar, v_thetav, theta_r2, coll], dim=-1)

    p_msg = _ped_messages(model, data)
    p_msg = p_msg.reshape(-1, p_msg.shape[-1])

    # The reference filters on the POLAR features (simulators.py:883-886),
    # but zero-padded neighbor slots map to θ_r² = π there, so most of the
    # extracted "edges" would be padding with r = 0 and |F| ≈ 0.  Filter on
    # the RAW feature row too: an all-zero row is "no neighbor", never a
    # physical contact at distance 0.
    raw_keep = torch.sum(torch.abs(feats), dim=-1) > 0
    keep = (torch.sum(torch.abs(features), dim=-1) > 0) & raw_keep
    features, p_msg = features[keep], p_msg[keep]

    if p_msg.shape[-1] > 2:
        # non-bottleneck: regress the two highest-variance message dims
        p_msg = p_msg.cpu().numpy()
        labels = p_msg[:, np.argsort(-p_msg.std(axis=0))]
    else:
        # bottleneck: polar magnitude/direction of the 2-D force
        labels = polar_mod.cart_to_polar(p_msg, _x_axis(p_msg)).cpu().numpy()
    return features.cpu().numpy(), labels


@torch.no_grad()
def prepare_vector_regression_data(
    model: torch.nn.Module, data: PointwiseData
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(dr (E, 2), dv (E, 2), F (E, 2)) raw per-edge triples for the joint
    vector force-law fit (sr.fit.fit_vector_force_law) — bottleneck models
    only (per-edge 2-D forces).  Padding edges (all-zero raw rows)
    dropped."""
    p_msg = _ped_messages(model, data)
    feats = data.ped_features.reshape(-1, data.ped_features.shape[-1])
    p_msg = p_msg.reshape(-1, p_msg.shape[-1])
    if p_msg.shape[-1] != 2:
        raise ValueError("vector regression needs a bottleneck model "
                         "(per-edge 2-D forces)")
    keep = torch.sum(torch.abs(feats), dim=-1) > 0
    feats, p_msg = feats[keep].cpu().numpy(), p_msg[keep].cpu().numpy()
    return feats[:, 0:2], feats[:, 2:4], p_msg


@torch.no_grad()
def prepare_symbolic_regression_data_polar(
    model: torch.nn.Module, data: PointwiseData
) -> Tuple[np.ndarray, np.ndarray]:
    """Polar-trained variant (reference: simulators.py:898-923)."""
    feats = data.ped_features.reshape(-1, data.ped_features.shape[-1])[:, :4]
    p_msg = _ped_messages(model, data)
    p_msg = p_msg.reshape(-1, p_msg.shape[-1])
    keep = feats[:, 0] > 1e-8
    return feats[keep].cpu().numpy(), p_msg[keep].cpu().numpy()


# ---------------------------------------------------------------------------
# filters (reference: symbolic_regression.py:55-115), numpy as in the JAX
# package, so the same labels and seed keep the same rows
# ---------------------------------------------------------------------------

def post_filter(features: np.ndarray, labels: np.ndarray, seed: int,
                n_bin: int = 200, min_sampling_points: int = 40):
    """Histogram rebalancing sampler over the label distribution."""
    if labels.size == 0:
        return features, labels
    lmax, lmin = labels.max(), labels.min()
    interval = np.floor((labels - lmin) * n_bin / max(lmax - lmin, 1e-12))
    interval = np.clip(interval, 0, n_bin - 1).astype(int)
    hist, _ = np.histogram(labels, bins=n_bin)
    with np.errstate(divide="ignore", invalid="ignore"):
        threshold = (min_sampling_points / hist) * (np.log10(hist) + 1) ** 2
    threshold = np.nan_to_num(threshold, posinf=1.0)
    threshold[threshold > 1] = 1
    prob = threshold[interval]
    rng = np.random.RandomState(seed)
    keep = rng.uniform(0, 1, labels.shape) < prob
    return features[keep], labels[keep]


def direction_filter(features: np.ndarray, labels: np.ndarray,
                     percentile: int = 75):
    """Keep only edges with large force magnitude for direction fitting."""
    magnitude = labels[:, 0]
    direction = labels[:, 1]
    thr = np.percentile(magnitude, percentile)
    keep = magnitude > thr
    return features[keep], direction[keep]

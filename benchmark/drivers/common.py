"""What the drivers share: the configuration's clip around the program's
model, the reference's model and neighbour settings, and the program's
kernel counters."""

from __future__ import annotations

import torch


def clamped(model, bound):
    """The configuration's acceleration clip around the program's model."""
    if not bound:
        return model

    def fn(pf, of, sf, rng=None):
        out = model(pf, of, sf, rng)
        return out._replace(pred_acc=torch.clamp(out.pred_acc, -bound, bound))

    return fn


def ref_spec(config: dict, dropout: float = 0.0) -> dict:
    w = config["widths"]
    return dict(encoder_hidden_layers=w["encoder_hidden_layers"],
                decoder_hidden_layers=w["decoder_hidden_layers"],
                bottleneck=w["bottleneck"],
                collision_head=w.get("collision_head"), dropout=dropout,
                tau=config["tau"], clamp=config.get("clamp"))


def neighbor(settings: dict) -> dict:
    keys = ("topk_ped", "topk_obs", "sight_angle_ped", "sight_angle_obs",
            "dist_threshold_ped", "dist_threshold_obs")
    return {k: settings[k] for k in keys}


def kernel_counts() -> dict:
    """The program's K2 / K1 launch and fallback counters."""
    from piml_tpu_torch.ops import banded, pairwise

    return dict(k2_launches=banded.KERNEL.launches,
                k2_fallbacks=banded.KERNEL.fallbacks,
                k1_launches=pairwise.KERNEL.launches)

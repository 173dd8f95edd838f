"""Faults planted in the timed path of ``sf_generate`` cells: the
program's social-force generator and its force law, wrapped."""

from __future__ import annotations

import dataclasses
import importlib

import torch

KINDS = ("unchanged", "half", "altered")


def plant(monkeypatch, kind: str) -> None:
    """``unchanged``: the generator returns its spawn state in every
    frame; ``half``: each frame takes half of its sub-steps, of the same
    length; ``altered``: the pedestrian repulsion's range moved by
    0.05 m."""
    sf = importlib.import_module("piml_tpu_torch.gen.socialforce")
    if kind == "unchanged":
        def frozen(params, schedule, obstacles, num_frames, *a,
                   device="cuda:0", **kw):
            sc = schedule.to(device)
            t = (num_frames, 1, 1)
            return (sc.position[None].repeat(t), sc.velocity[None].repeat(t),
                    torch.ones((num_frames, sc.position.shape[0]),
                               device=device))

        monkeypatch.setattr(sf, "simulate", frozen)
        return
    if kind == "half":
        simulate = sf.simulate

        def halved(params, *a, **kw):
            return simulate(dataclasses.replace(
                params, oversampling=params.oversampling // 2,
                time_unit=params.time_unit / 2), *a, **kw)

        monkeypatch.setattr(sf, "simulate", halved)
        return
    law = sf.social_force

    def altered(params, *a, **kw):
        return law(dataclasses.replace(
            params,
            pedped_repulsive_radius=params.pedped_repulsive_radius + 0.05),
            *a, **kw)

    monkeypatch.setattr(sf, "social_force", altered)

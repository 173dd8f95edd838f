"""Faults planted in the timed path of ``eval_scoring`` cells: the
program's evaluation rollout and its scores, wrapped."""

from __future__ import annotations

import importlib

import torch

KINDS = ("unchanged", "half", "altered")


def plant(monkeypatch, kind: str) -> None:
    """``unchanged``: the rollout returns its first predicted state in
    every later frame; ``half``: MAE, OT and MMD scored on every other
    frame only; ``altered``: the OT cost 2 % high."""
    sim = importlib.import_module("piml_tpu_torch.engine.simulator")
    if kind == "unchanged":
        roll = sim.eval_rollout

        def frozen(model, ecfg, data, t_start, *a, **kw):
            res = roll(model, ecfg, data, t_start, *a, **kw)
            held = res.position[t_start:t_start + 1].expand_as(
                res.position[t_start:])
            return res._replace(position=torch.cat(
                [res.position[:t_start], held]))

        monkeypatch.setattr(sim, "eval_rollout", frozen)
        return
    if kind == "altered":
        ot = sim.ot_with_time_mask
        monkeypatch.setattr(sim, "ot_with_time_mask",
                            lambda *a, **kw: ot(*a, **kw) * 1.02)
        return
    for name in ("mae_with_time_mask", "ot_with_time_mask",
                 "mmd_with_time_mask"):
        score = getattr(sim, name)

        def halved(p, q, mask, *a, _score=score, **kw):
            odd = (torch.arange(mask.shape[0], device=mask.device) % 2
                   == 1)[:, None]
            return _score(p, q, torch.where(odd, 0.0, mask), *a, **kw)

        monkeypatch.setattr(sim, name, halved)

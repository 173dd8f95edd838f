"""Faults planted in the timed path of ``rollout_episodes`` cells: the
program's frame step, wrapped."""

from __future__ import annotations

import dataclasses
import importlib

import torch

KINDS = ("unchanged", "half", "altered")


def plant(monkeypatch, kind: str) -> None:
    """``unchanged``: the step returns its state; ``half``: every other
    agent left out of the step; ``altered``: one agent's position moved."""
    rollout_mod = importlib.import_module("piml_tpu_torch.engine.rollout")
    make_step = rollout_mod.make_step

    def broken(*a, **kw):
        step = make_step(*a, **kw)

        def wrapped(state, spawn, seeds=None):
            new, out = step(state, spawn, seeds)
            if kind == "unchanged":
                return state, out
            if kind == "half":
                odd = torch.arange(state.p.shape[0]) % 2 == 1

                def mix(a, b):
                    m = odd.reshape((-1,) + (1,) * (a.ndim - 1))
                    return torch.where(m, b, a)

                return dataclasses.replace(new, **{
                    f.name: mix(getattr(new, f.name), getattr(state, f.name))
                    for f in dataclasses.fields(new)}), out
            p = new.p.clone()
            p[0] += 0.5
            return dataclasses.replace(new, p=p), out

        return wrapped

    monkeypatch.setattr(rollout_mod, "make_step", broken)

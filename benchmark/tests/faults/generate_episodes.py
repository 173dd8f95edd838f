"""Faults planted in the timed path of ``generate_episodes`` cells: the
program's generator and its force law, wrapped."""

from __future__ import annotations

import dataclasses
import importlib

import torch

KINDS = ("unchanged", "half", "altered")


def plant(monkeypatch, kind: str) -> None:
    """``unchanged``: the generator returns its spawn state in every
    frame; ``half``: the even agents' forces leave out the odd agents
    (half of their pairs); ``altered``: the law's ``C`` moved by 0.05."""
    sim = importlib.import_module("piml_tpu_torch.gen.mlapm_sim")
    if kind == "unchanged":
        def frozen(params, schedule, num_frames, *a, device="cuda:0", **kw):
            sc = schedule.to(device)
            t = (num_frames, 1, 1)
            return (sc.position[None].repeat(t), sc.velocity[None].repeat(t),
                    torch.ones((num_frames, sc.position.shape[0]),
                               device=device))

        monkeypatch.setattr(sim, "simulate_mlapm", frozen)
        return
    step = sim.mlapm_step

    def broken(params, position, velocity, desired_speed, destination, dt,
               radius=0.3):
        if kind == "altered":
            return step(dataclasses.replace(params, C=params.C + 0.05),
                        position, velocity, desired_speed, destination, dt,
                        radius)
        odd = (torch.arange(position.shape[0]) % 2 == 1)[:, None]
        whole = step(params, position, velocity, desired_speed, destination,
                     dt, radius)
        evens = step(params, torch.where(odd, torch.nan, position), velocity,
                     desired_speed, destination, dt, radius)
        return torch.where(odd, whole, evens)

    monkeypatch.setattr(sim, "mlapm_step", broken)

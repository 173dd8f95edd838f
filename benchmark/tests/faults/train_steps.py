"""Faults planted in the timed path of ``train_steps`` cells: the
program's loss and its optimizer step, wrapped."""

from __future__ import annotations

import torch

KINDS = ("unchanged", "half", "altered")


def plant(monkeypatch, kind: str) -> None:
    """``half``: half of the batch's windows left out, the loss scaled to
    their mean; ``altered``: one gradient leaf doubled; ``unchanged``: the
    step returns the parameters as they were."""
    import piml_tpu_torch.engine as engine

    if kind == "half":
        loss_fn = engine.training_rollout_loss

        def half(model, cfg, batch, generator=None, *, seeds=None, total=None):
            keep = max(1, batch.num_channels // 2)
            out = loss_fn(model, cfg, batch.slice_channels(list(range(keep))),
                          seeds=seeds[:keep], total=total)
            return out._replace(loss=out.loss * (batch.num_channels / keep))

        monkeypatch.setattr(engine, "training_rollout_loss", half)
        return
    adam_step = torch.optim.Adam.step

    def broken(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"]]
        if kind == "altered":
            params[0].grad.mul_(2.0)
            return adam_step(self, closure)
        before = [p.detach().clone() for p in params]
        adam_step(self, closure)
        with torch.no_grad():
            for p, b in zip(params, before):
                p.copy_(b)

    monkeypatch.setattr(torch.optim.Adam, "step", broken)

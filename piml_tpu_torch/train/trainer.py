"""The BPTT finetune loop (reference: src/models/simulators.py:291-428).

Counterpart of the finetune half of ``piml_tpu/train/trainer.py``.  The
JAX package compiles a whole epoch into one ``lax.scan`` over stacked
batches; here an epoch is a Python loop over ``channel_batches``, one
``backward`` and one optimizer step per batch, with one host read of the
batch's loss terms.

Not ported yet (ROADMAP.md): pointwise pretraining (``train_pointwise``),
resumable training state (``train/checkpoint.py``), channel data
parallelism, and the test evaluation with OT / MMD.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from piml_tpu_torch.config import PIMLConfig
from piml_tpu_torch.data.views import ChanneledData, TimeIndexedData
from piml_tpu_torch.engine.simulator import (evaluate_rollouts,
                                             training_rollout_loss)
from piml_tpu_torch.models import ModelSpec, build_finetune_model

StateDict = Dict[str, torch.Tensor]


def make_optimizer(cfg: PIMLConfig, params, finetune: bool = False
                   ) -> torch.optim.Optimizer:
    """Adam with coupled L2 weight decay, as the reference builds it.

    ``torch.optim.Adam(weight_decay=wd)`` adds ``wd·θ`` to the gradient
    before the moments, which is exactly the JAX package's
    ``optax.chain(add_decayed_weights(wd), scale_by_adam(), scale(-lr))``
    (same b1 = 0.9, b2 = 0.999, eps = 1e-8 outside the square root, bias
    correction on both moments).  The finetune scales the learning rate by
    ``finetune_lr_decay`` and the decay by ``finetune_wd_aug``
    (simulators.py:125-131); ``base`` and ``pinnsf_res``, whose finetune
    has per-group learning rates, are not ported yet."""
    lr, wd = cfg.learning_rate, cfg.weight_decay
    if finetune:
        if cfg.model in ("base", "pinnsf_res"):
            raise NotImplementedError(
                f"the {cfg.model!r} finetune optimizer is not ported yet")
        lr, wd = lr * cfg.finetune_lr_decay, wd * cfg.finetune_wd_aug
    return torch.optim.Adam(params, lr=lr, weight_decay=wd)


def make_batches(n: int, batch_size: int, rng: np.random.RandomState,
                 shuffle: bool = True, drop_last: bool = True
                 ) -> List[np.ndarray]:
    """Shuffled index chunks (reference: src/utils/data_loader.py:14-38)."""
    idx = np.arange(n)
    if shuffle:
        idx = idx[rng.permutation(n)]
    batches = [idx[i * batch_size:(i + 1) * batch_size]
               for i in range(n // batch_size)]
    if not drop_last and n % batch_size:
        batches.append(idx[n - n % batch_size:])
    return batches


# ---------------------------------------------------------------------------
# checkpoints (reference: simulators.py:251-289 naming contract)
# ---------------------------------------------------------------------------

def checkpoint_path(cfg: PIMLConfig, finetuned: bool) -> str:
    os.makedirs(cfg.save_dir, exist_ok=True)
    path = os.path.join(cfg.save_dir,
                        f"{cfg.exp_name}_{cfg.model_name_suffix}")
    return path + "_finetuned" if finetuned else path


def save_params(path: str, params: Mapping[str, torch.Tensor]) -> None:
    """A ``state_dict`` file (``torch.save``), tensors moved to the CPU."""
    torch.save({k: v.detach().cpu() for k, v in params.items()}, path)


def load_params(path: str) -> StateDict:
    return torch.load(path, map_location="cpu", weights_only=True)


def merge_pretrained(ft_params: Mapping[str, torch.Tensor],
                     pretrained: Mapping[str, torch.Tensor]) -> StateDict:
    """Partial warm start: every pretrained tensor whose name and shape
    exist in the finetune model replaces the fresh one (reference:
    simulators.py:417-422)."""
    merged = {}
    for name, fresh in ft_params.items():
        pre = pretrained.get(name)
        merged[name] = (pre.to(fresh.device, fresh.dtype)
                        if pre is not None and pre.shape == fresh.shape
                        else fresh)
    return merged


@dataclass
class TrainState:
    params: StateDict
    opt_state: Dict[str, Any]
    epoch: int = 0
    best_val: float = float("inf")
    patience: int = 0


@dataclass
class MetricLogger:
    """Metric records kept in ``records`` and printed one line each."""

    stream: Any = None
    records: List[Dict[str, Any]] = field(default_factory=list)

    def info(self, msg: str) -> None:
        print(msg, file=self.stream or sys.stdout)

    def log(self, **metrics) -> None:
        self.records.append(metrics)
        self.info(", ".join(f"{k}={v:.6g}" if isinstance(v, float)
                            else f"{k}={v}" for k, v in metrics.items()))


class Trainer:
    """The finetune loop (reference: BaseSimulator.finetune)."""

    def __init__(self, cfg: PIMLConfig, logger: Optional[MetricLogger] = None):
        self.cfg = cfg
        self.logger = logger or MetricLogger()
        self.model: Optional[torch.nn.Module] = None

    def finetune(self, train_batches: List[ChanneledData],
                 valid_data: List[TimeIndexedData],
                 pretrained: Optional[Mapping[str, torch.Tensor]] = None
                 ) -> TrainState:
        """Rollout finetuning (reference: simulators.py:409-428): a fresh
        finetune model warm-started from ``pretrained`` (default: the
        pretrain checkpoint, when it exists), BPTT through the rollout of
        each batch of windows, validation by ``evaluate_rollouts`` without
        OT / MMD after every epoch, early stopping on the patience, and
        the best-validation parameters in the result and in
        ``self.model``.  Everything runs on the device of the batches."""
        cfg = self.cfg
        device = train_batches[0].position.device
        # the model's initial weights come from cfg.seed without touching
        # the caller's global RNG
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            model = build_finetune_model(ModelSpec.from_config(cfg))
        model = model.to(device)
        if pretrained is None:
            pre_path = checkpoint_path(cfg, finetuned=False)
            if os.path.exists(pre_path):
                pretrained = load_params(pre_path)
                self.logger.info(f"warm start from {pre_path}")
        if pretrained is not None:
            model.load_state_dict(merge_pretrained(model.state_dict(),
                                                   pretrained))
        self.model = model
        opt = make_optimizer(cfg, model.parameters(), finetune=True)
        state = TrainState(params=model.state_dict(), opt_state={})

        def snapshot() -> StateDict:
            return {k: v.detach().clone()
                    for k, v in model.state_dict().items()}

        def validate() -> float:
            m = evaluate_rollouts(model, cfg, valid_data, test_flag=False)
            self.logger.log(val_loss=m.loss, val_mse=m.mse,
                            val_coll=m.collision,
                            val_hard_coll=m.hard_collision)
            return m.loss

        patience_limit = (cfg.patience if cfg.compat_swapped_patience
                          else cfg.ft_patience)
        # epoch-0 checkpoint and baseline validation (simulators.py:298-304)
        ck_path = checkpoint_path(cfg, finetuned=True)
        save_params(ck_path, model.state_dict())
        best_params = snapshot()
        state.best_val = validate()
        n_train = max(sum(int((b.mask_p_pred == 1).sum())
                          for b in train_batches), 1)
        keys = ("coll_count", "hard_count", "loss", "mse", "coll", "hard",
                "cp", "reg")

        start = time.time()
        for epoch in range(cfg.epochs):
            state.epoch = epoch
            log = dict.fromkeys(keys, 0.0)
            # dropout seeds depend only on (seed, epoch)
            gen = None
            if cfg.dropout > 0:
                gen = torch.Generator().manual_seed(
                    (cfg.seed + 1) * 1_000_003 + epoch)
            for batch in train_batches:
                out = training_rollout_loss(model, cfg, batch, generator=gen)
                opt.zero_grad(set_to_none=True)
                out.loss.backward()
                opt.step()
                # one host read per batch
                vals = torch.stack([
                    out.collision_count, out.hard_collision_count,
                    out.loss, out.mse_loss, out.collision_loss,
                    out.hard_collision_loss, out.collision_pred_loss,
                    out.reg_loss]).detach().double().tolist()
                for k, v in zip(keys, vals):
                    log[k] += v
            self.logger.log(
                epoch=epoch, time=time.time() - start,
                train_loss=log["loss"] / n_train,
                train_mse=log["mse"] / n_train,
                coll_loss=log["coll"] / n_train,
                hard_coll_loss=log["hard"] / n_train,
                coll_count=log["coll_count"], hard_coll_count=log["hard_count"])

            val_loss = validate()
            if val_loss < state.best_val:
                self.logger.info(f"model saved at epoch {epoch}")
                save_params(ck_path, model.state_dict())
                best_params = snapshot()
                state.best_val = val_loss
                state.patience = 0
            else:
                state.patience += 1
                if state.patience > patience_limit:
                    break

        # the reference evaluates the best-validation checkpoint
        # (simulators.py:427,563-564)
        model.load_state_dict(best_params)
        state.params = best_params
        state.opt_state = opt.state_dict()
        return state

"""Training loops: pointwise pretraining and the BPTT finetune
(reference: src/models/simulators.py:291-428).

Counterpart of ``piml_tpu/train/trainer.py``.  The JAX package compiles a
whole epoch into one ``lax.scan`` over batches; here an epoch is a Python
loop, one ``backward`` and one optimizer step per batch.  The pretrain
reads the host once per epoch (the summed loss terms and the validation
MSE together); the finetune once per batch.  Shuffling and dropout depend
only on ``(seed, epoch)``, so a run resumed from its last full training
state (``train/checkpoint.py``) continues bit for bit.  Both loops run on
the device their data lies on.  ``cfg.n_devices > 1`` runs the finetune
channel data-parallel over that many ranks (``parallel/sharding.py``).
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from piml_tpu_torch.config import PIMLConfig
from piml_tpu_torch.data.datasets import channel_batches
from piml_tpu_torch.data.views import (ChanneledData, PointwiseData,
                                       TimeIndexedData)
from piml_tpu_torch.engine.simulator import (evaluate_rollouts,
                                             training_rollout_loss)
from piml_tpu_torch.models import (ModelSpec, build_finetune_model,
                                   build_model, pretrain_model_name)
from piml_tpu_torch.parallel.sharding import (make_dp_finetune_step,
                                              make_mesh, replicate)
from piml_tpu_torch.physics import forces
from piml_tpu_torch.train import checkpoint as ckpt
from piml_tpu_torch.train import losses
from piml_tpu_torch.utils.logging import MetricLogger  # noqa: F401

StateDict = Dict[str, torch.Tensor]
# rows per validation chunk of the pretrain (the JAX package's lax.map)
VAL_CHUNK = 8192


# finetunes whose corrector branch gets a learning rate of its own
# (simulators.py:108-124)
GROUPED_FINETUNES = ("base", "pinnsf_res")


def make_optimizer(cfg: PIMLConfig, params, finetune: bool = False
                   ) -> torch.optim.Optimizer:
    """Adam with coupled L2 weight decay, as the reference builds it.

    ``torch.optim.Adam(weight_decay=wd)`` adds ``wd·θ`` to the gradient
    before the moments, which is exactly the JAX package's
    ``optax.chain(add_decayed_weights(wd), scale_by_adam(), scale(-lr))``
    (same b1 = 0.9, b2 = 0.999, eps = 1e-8 outside the square root, bias
    correction on both moments).  The finetune scales the learning rate by
    ``finetune_lr_decay`` and the decay by ``finetune_wd_aug``
    (simulators.py:125-131); the finetunes of ``GROUPED_FINETUNES`` have
    two parameter groups instead, the JAX package's
    ``optax.multi_transform`` split on ``"corrector"`` in the parameter's
    name: the corrector at ``lr·ft_lr_decay2``, the pretrained weights at
    ``lr·finetune_lr_decay``, both with decay ``wd``.

    ``params``: the model, or its parameters (which cannot be split into
    groups)."""
    lr, wd = cfg.learning_rate, cfg.weight_decay
    if finetune and cfg.model in GROUPED_FINETUNES:
        if not isinstance(params, torch.nn.Module):
            raise ValueError(f"the {cfg.model!r} finetune optimizer splits "
                             "parameters by name: pass the model")
        named = list(params.named_parameters())
        return torch.optim.Adam(
            [{"params": [p for n, p in named if "corrector" in n],
              "lr": lr * cfg.ft_lr_decay2},
             {"params": [p for n, p in named if "corrector" not in n],
              "lr": lr * cfg.finetune_lr_decay}],
            lr=lr, weight_decay=wd)
    if isinstance(params, torch.nn.Module):
        params = params.parameters()
    if finetune:
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


def _snapshot(model: torch.nn.Module) -> StateDict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _resume_dir(cfg: PIMLConfig, finetuned: bool) -> str:
    return checkpoint_path(cfg, finetuned) + "_resume"


def _save_resumable(cfg: PIMLConfig, state: TrainState,
                    model: torch.nn.Module, opt: torch.optim.Optimizer,
                    finetuned: bool) -> None:
    ckpt.save_train_state(
        _resume_dir(cfg, finetuned), state.epoch, model.state_dict(),
        opt.state_dict(),
        extra={"best_val": state.best_val, "patience": state.patience,
               "epoch": state.epoch})


def _try_resume(cfg: PIMLConfig, state: TrainState, model: torch.nn.Module,
                opt: torch.optim.Optimizer, finetuned: bool,
                logger: MetricLogger) -> int:
    """Restore the latest full training state into ``model``, ``opt`` and
    ``state``; returns the epoch to start from (0 without a checkpoint).
    Epoch-granular: shuffling and dropout derive from ``(seed, epoch)``,
    so the continuation is bit-identical to an uninterrupted run."""
    restored = ckpt.restore_train_state(_resume_dir(cfg, finetuned))
    if restored is None:
        return 0
    model.load_state_dict(restored["params"])
    opt.load_state_dict(restored["opt_state"])
    extra = restored["extra"]
    state.best_val = float(extra["best_val"])
    state.patience = int(extra["patience"])
    start = int(extra["epoch"]) + 1
    logger.info(f"resumed from epoch {start - 1} "
                f"(best_val={state.best_val:.6f}, patience={state.patience})")
    return start


def _epoch_generator(seed: int, stream: int, epoch: int,
                     device: torch.device) -> torch.Generator:
    """The dropout stream of one epoch: a function of (seed, epoch) only."""
    return torch.Generator(device=device).manual_seed(
        (seed + stream) * 1_000_003 + epoch)


def _check_group(n_devices: int) -> bool:
    """Whether the finetune runs data-parallel (``n_devices > 1``); raises
    unless this process is a rank of a group of exactly ``n_devices``."""
    if n_devices <= 1:
        return False
    if not dist.is_initialized() or dist.get_world_size() != n_devices:
        have = (f"a group of {dist.get_world_size()}"
                if dist.is_initialized() else "no process group")
        raise RuntimeError(
            f"n_devices={n_devices} runs channel data parallelism over "
            f"{n_devices} ranks, but this process has {have}: launch it "
            f"with torchrun --nproc_per_node={n_devices} and call "
            "parallel.init_distributed(), or with parallel.spawn_local")
    return True


class Trainer:
    """Pretrain / finetune driver (reference: BaseSimulator.train and
    .finetune)."""

    def __init__(self, cfg: PIMLConfig, logger: Optional[MetricLogger] = None):
        self.cfg = cfg
        self.logger = logger or MetricLogger()
        self.model: Optional[torch.nn.Module] = None

    # ------------------------------------------------------------------
    def init_params(self, sample: PointwiseData) -> StateDict:
        """Build the pretrain model from ``cfg.seed`` (without touching the
        caller's global RNG) on the device of ``sample``; it becomes
        ``self.model``.  Returns its ``state_dict``."""
        cfg = self.cfg
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            model = build_model(ModelSpec.from_config(
                cfg, name=pretrain_model_name(cfg.model)))
        self.model = model.to(sample.labels.device)
        n = sum(p.numel() for p in self.model.parameters())
        self.logger.info(f"#Trainable Parameters: {n}")
        return self.model.state_dict()

    def _pointwise_loss_terms(self, ped: torch.Tensor, obs: torch.Tensor,
                              self_f: torch.Tensor, labels: torch.Tensor,
                              rng: Optional[torch.Generator] = None
                              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                             ...]]:
        """The pretrain loss stack of ``self.model`` on one batch of rows
        (reference: simulators.py:327-359): ``(loss, (mse, reg, cp_loss,
        cp_acc))``.  ``rng`` makes dropout live."""
        cfg = self.cfg
        out = self.model(ped, obs, self_f, rng)
        pred, p_msg = out.pred_acc, out.ped_msgs
        if cfg.pinnsf_interaction == "loss":
            analytic = forces.pairwise_acceleration(
                ped, "v2" if cfg.iter_flag else "v0", cfg.dataset_name,
                dv_from_velocity=cfg.sf_dv_from_velocity)
            mse = (((p_msg - analytic) ** 2).sum()
                   + cfg.true_label_weight
                   * ((pred - labels[:, 4:6]) ** 2).sum())
        else:
            mse = ((pred - labels[:, 4:6]) ** 2).sum()
        loss = mse
        zero = torch.zeros((), device=pred.device)
        reg = cp_loss = cp_acc = zero
        if cfg.reg_weight > 0 and p_msg is not None:
            reg = losses.l1_reg_loss(p_msg, cfg.reg_weight, "sum")
            loss = loss + reg
        if (cfg.collision_pred_weight > 0 and out.coll_pred is not None
                and cfg.model == "pinnsf_bm"):
            target = labels[:, 6:]
            cp_loss = losses.binary_cross_entropy(out.coll_pred, target,
                                                  "sum")
            cp_acc = (torch.round(out.coll_pred) == target).to(
                pred.dtype).mean()
            # the reference pretrain adds the BCE unweighted
            # (simulators.py:354; the weight only gates it)
            w = (1.0 if cfg.compat_unweighted_coll_pred
                 else cfg.collision_pred_weight)
            loss = loss + w * cp_loss
        return loss, (mse, reg, cp_loss, cp_acc)

    @torch.no_grad()
    def _validate_pointwise(self, valid: PointwiseData) -> torch.Tensor:
        """Deterministic validation MSE over ``VAL_CHUNK``-row chunks:
        ``sq_sum / (2 n_valid)`` (reference: simulators.py:430-441), or the
        message-supervision objective under ``val_on_train_objective``.
        An empty validation set gives NaN, which never improves on the
        best loss, as in the JAX package."""
        cfg = self.cfg
        supervise_msgs = (cfg.val_on_train_objective
                          and cfg.pinnsf_interaction == "loss")
        sq = torch.zeros((), device=valid.labels.device)
        for s in range(0, len(valid), VAL_CHUNK):
            ped = valid.ped_features[s:s + VAL_CHUNK]
            out = self.model(ped, valid.obs_features[s:s + VAL_CHUNK],
                             valid.self_features[s:s + VAL_CHUNK])
            if supervise_msgs:
                analytic = forces.pairwise_acceleration(
                    ped, "v2" if cfg.iter_flag else "v0", cfg.dataset_name,
                    dv_from_velocity=cfg.sf_dv_from_velocity)
                sq = sq + ((out.ped_msgs - analytic) ** 2).sum()
            else:
                lab = valid.labels[s:s + VAL_CHUNK, 4:6]
                sq = sq + ((out.pred_acc - lab) ** 2).sum()
        return sq / (2.0 * len(valid))

    def train_pointwise(self, train_data: PointwiseData,
                        valid_data: PointwiseData,
                        params: Optional[Mapping[str, torch.Tensor]] = None
                        ) -> TrainState:
        """Pointwise pretraining with early stopping (reference:
        simulators.py:291-393, tensor-batch branch): the seeded model (or
        ``params``), per-epoch permutation ``RandomState(seed + epoch)``
        cut to ``max(n // batch_size, 1)`` batches of ``min(batch_size,
        n)`` rows, dropout from ``(seed, epoch)``, validation after every
        epoch, and the best-validation parameters in the result and in
        ``self.model``."""
        cfg = self.cfg
        device = train_data.labels.device
        self.init_params(train_data)
        model = self.model
        if params is not None:
            model.load_state_dict(params)
        opt = make_optimizer(cfg, model.parameters())
        state = TrainState(params=model.state_dict(), opt_state={})
        patience_limit = (cfg.ft_patience if cfg.compat_swapped_patience
                          else cfg.patience)
        ck_path = checkpoint_path(cfg, False)
        start_epoch = (_try_resume(cfg, state, model, opt, False, self.logger)
                       if cfg.resume else 0)
        best = (load_params(ck_path)
                if start_epoch and os.path.exists(ck_path)
                else _snapshot(model))

        n = len(train_data)
        n_batches = max(n // cfg.batch_size, 1)
        batch_size = min(cfg.batch_size, n)
        n_train = n_batches * batch_size
        start = time.time()
        for epoch in range(start_epoch, cfg.epochs):
            state.epoch = epoch
            perm = np.random.RandomState(cfg.seed + epoch).permutation(n)
            batch_idx = torch.from_numpy(
                perm[:n_train].reshape(n_batches, batch_size)).to(device)
            gen = (_epoch_generator(cfg.seed, 0, epoch, device)
                   if cfg.dropout > 0 else None)
            stats = torch.zeros(5, device=device)
            for idx in batch_idx:
                loss, (mse, reg, cp, cp_acc) = self._pointwise_loss_terms(
                    train_data.ped_features[idx],
                    train_data.obs_features[idx],
                    train_data.self_features[idx], train_data.labels[idx],
                    gen)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                stats += torch.stack(
                    [loss, mse, reg, cp, cp_acc * batch_size]).detach()
            val = self._validate_pointwise(valid_data)
            # one host read per epoch
            vals = torch.cat([stats, val[None]]).double().tolist()
            self.logger.log(
                epoch=epoch, time=time.time() - start,
                train_loss=vals[0] / n_train, train_mse=vals[1] / n_train,
                coll_pred=vals[3] / n_train, acc_pred=vals[4] / n_train)
            val_loss = vals[5]
            self.logger.log(epoch=epoch, val_loss=val_loss, val_mse=val_loss)

            if val_loss < state.best_val:
                self.logger.info(f"model saved at epoch {epoch}")
                save_params(ck_path, model.state_dict())
                best = _snapshot(model)
                state.best_val = val_loss
                state.patience = 0
            else:
                state.patience += 1
                if state.patience > patience_limit:
                    break
            if cfg.resume and epoch % max(cfg.resume_every, 1) == 0:
                _save_resumable(cfg, state, model, opt, False)

        # the reference evaluates the best-validation checkpoint
        # (simulators.py:563-564)
        model.load_state_dict(best)
        state.params = _snapshot(model)
        state.opt_state = opt.state_dict()
        return state

    # ------------------------------------------------------------------
    def finetune(self, train_batches: Optional[List[ChanneledData]] = None,
                 valid_data: Optional[List[TimeIndexedData]] = None,
                 test_data: Optional[List[TimeIndexedData]] = None,
                 pretrained: Optional[Mapping[str, torch.Tensor]] = None, *,
                 train_scenes: Optional[List[ChanneledData]] = None,
                 shuffle: bool = True) -> TrainState:
        """Rollout finetuning (reference: simulators.py:409-428): a fresh
        finetune model warm-started from ``pretrained`` (default: the
        pretrain checkpoint, when it exists), BPTT through the rollout of
        each batch of windows, validation by ``evaluate_rollouts`` without
        OT / MMD after every epoch, early stopping on the patience, and
        the best-validation parameters in the result and in
        ``self.model``; then, with ``test_data``, the test metrics of
        those parameters (with OT and MMD).

        Pass either ``train_batches`` (a :func:`channel_batches` list) or
        ``train_scenes`` (the windowed scenes), batched here as
        ``channel_batches(train_scenes, cfg.ft_batch_size,
        RandomState(cfg.seed), shuffle)``.  Everything runs on the device
        of the batches.

        ``cfg.n_devices > 1``: channel data parallelism (the JAX package's
        ``piml_tpu/train/trainer.py:601-652``) over a process group of
        exactly that many ranks (``torchrun --nproc_per_node=N``, or
        ``parallel.spawn_local``), each passing the same batches on its own
        device: every batch's channels are padded to the ranks and split
        over them, the gradients summed (:func:`make_dp_finetune_step`);
        rank 0 alone validates (its loss is broadcast), tests and writes
        checkpoints, and the parameters stay the same on every rank."""
        cfg = self.cfg
        data_parallel = _check_group(cfg.n_devices)
        if (train_batches is None) == (train_scenes is None):
            raise ValueError("pass exactly one of train_batches / "
                             "train_scenes")
        if train_scenes is not None:
            train_batches = channel_batches(
                train_scenes, cfg.ft_batch_size,
                np.random.RandomState(cfg.seed), shuffle=shuffle)
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
        opt = make_optimizer(cfg, model, finetune=True)
        state = TrainState(params=model.state_dict(), opt_state={})
        mesh, lead = None, True
        if data_parallel:
            self.logger.info(f"finetune: channel-DP over {cfg.n_devices} "
                             "ranks")
            mesh = make_mesh(cfg.n_devices, "dp", device=device.type)
            lead = dist.get_rank() == 0
            replicate(model, mesh)
            dp_step = make_dp_finetune_step(cfg, model, opt, mesh)

        def validate() -> float:
            loss = math.nan
            if lead:
                m = evaluate_rollouts(model, cfg, valid_data,
                                      test_flag=False)
                self.logger.log(val_loss=m.loss, val_mse=m.mse,
                                val_coll=m.collision,
                                val_hard_coll=m.hard_collision)
                loss = m.loss
            if mesh is not None:        # rank 0's loss on every rank
                loss = float(replicate(torch.tensor(
                    loss, dtype=torch.float64, device=device), mesh))
            return loss

        def save(path, params):
            if lead:
                save_params(path, params)

        patience_limit = (cfg.patience if cfg.compat_swapped_patience
                          else cfg.ft_patience)
        ck_path = checkpoint_path(cfg, finetuned=True)
        start_epoch = (_try_resume(cfg, state, model, opt, True, self.logger)
                       if cfg.resume else 0)
        if start_epoch:
            best_params = (load_params(ck_path) if os.path.exists(ck_path)
                           else _snapshot(model))
        else:
            # epoch-0 checkpoint and baseline validation
            # (simulators.py:298-304)
            save(ck_path, model.state_dict())
            best_params = _snapshot(model)
            state.best_val = validate()
        n_train = max(sum(int((b.mask_p_pred == 1).sum())
                          for b in train_batches), 1)
        keys = ("coll_count", "hard_count", "loss", "mse", "coll", "hard",
                "cp", "reg")

        start = time.time()
        for epoch in range(start_epoch, cfg.epochs):
            state.epoch = epoch
            log = dict.fromkeys(keys, 0.0)
            # dropout seeds depend only on (seed, epoch)
            gen = None
            if cfg.dropout > 0:
                gen = _epoch_generator(cfg.seed, 1, epoch,
                                       torch.device("cpu"))
            for batch in train_batches:
                if mesh is not None:
                    out = dp_step(batch, gen)
                else:
                    out = training_rollout_loss(model, cfg, batch,
                                                generator=gen)
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
                save(ck_path, model.state_dict())
                best_params = _snapshot(model)
                state.best_val = val_loss
                state.patience = 0
            else:
                state.patience += 1
                if state.patience > patience_limit:
                    break
            if (cfg.resume and epoch % max(cfg.resume_every, 1) == 0
                    and lead):
                _save_resumable(cfg, state, model, opt, True)

        # the reference evaluates the best-validation checkpoint
        # (simulators.py:427,563-564)
        model.load_state_dict(best_params)
        state.params = _snapshot(model)
        state.opt_state = opt.state_dict()
        if test_data and lead:
            m = evaluate_rollouts(model, cfg, test_data, test_flag=True)
            self.logger.log(test_loss=m.loss, test_mse=m.mse, test_mae=m.mae,
                            test_ot=m.ot, test_mmd=m.mmd,
                            test_coll=m.collision,
                            test_hard_coll=m.hard_collision)
        return state

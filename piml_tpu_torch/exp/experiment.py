"""Staged pretrain → finetune → evaluate experiment runner.

Counterpart of ``piml_tpu/exp/experiment.py``.  The reference runs this
pipeline in one go (src/main.py:126-174); here each stage can run on its
own and resumes from the previous one: results accumulate in a JSON state
file and the weights in ``cfg.save_dir``'s checkpoints, so a long run can
be driven stage by stage.  A resumed stage loads the port's own
``state_dict`` checkpoints (``train/trainer.py`` ``load_params``,
``checkpoint_path``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional, Union

import torch

from piml_tpu_torch.config import PIMLConfig
from piml_tpu_torch.data import FinetuneDataset, PointwiseDataset
from piml_tpu_torch.engine import evaluate_rollouts
from piml_tpu_torch.metrics import collision_count
from piml_tpu_torch.models import (ModelSpec, build_finetune_model,
                                   build_model, pretrain_model_name)
from piml_tpu_torch.train.trainer import Trainer, checkpoint_path, load_params
from piml_tpu_torch.utils import MetricLogger

STAGES = ("all", "pretrain", "finetune", "evaluate")


def read_state(path: str) -> dict:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def write_state(path: str, results: dict) -> None:
    with open(path, "w") as f:
        json.dump(results, f, indent=2, default=float)


def _saved_model(cfg: PIMLConfig, finetuned: bool,
                 device: Union[str, torch.device]) -> torch.nn.Module:
    """The pretrain (or finetune) model with its checkpoint's weights."""
    if finetuned:
        model = build_finetune_model(ModelSpec.from_config(cfg))
    else:
        model = build_model(ModelSpec.from_config(
            cfg, name=pretrain_model_name(cfg.model)))
    model.load_state_dict(load_params(checkpoint_path(cfg, finetuned)))
    return model.to(device)


def run_staged_experiment(cfg: PIMLConfig, stage: str, state_path: str,
                          logger: Optional[MetricLogger] = None,
                          device: Union[str, torch.device] = "cuda:0"
                          ) -> dict:
    """``stage`` ∈ {all, pretrain, finetune, evaluate}, on ``device``.
    Returns the accumulated results (also written to ``state_path`` after
    every stage).

    - ``pretrain``: pointwise pretraining on ``cfg.data_config``;
    - ``finetune``: the pretrained model judged on the first test scene
      of ``cfg.ft_data_config`` (once per state file), then the rollout
      finetune and the finetuned model's test metrics;
    - ``evaluate``: the same judgement and the saved finetuned model's
      test metrics, without training;
    - ``all``: pretrain, then finetune."""
    if stage not in STAGES:
        raise ValueError(f"stage {stage!r} not in {STAGES}")
    logger = logger or MetricLogger()
    results = read_state(state_path)
    t_all = time.time()
    trainer = None
    params = None

    # ---- pretrain on synthetic social-force data ---------------------------
    if stage in ("all", "pretrain"):
        synth = PointwiseDataset(device=device)
        synth.load_data(cfg.data_config)
        cfg = synth.build_dataset(cfg)
        logger.info(f"pretrain rows: train={len(synth.train_data)} "
                    f"valid={len(synth.valid_data)}")
        trainer = Trainer(cfg, logger)
        t0 = time.time()
        state = trainer.train_pointwise(synth.train_data, synth.valid_data)
        results["pretrain"] = {
            "val_mse": state.best_val, "wall_s": time.time() - t0,
            "epochs_ran": state.epoch + 1,
        }
        write_state(state_path, results)
        params = state.params
        if stage == "pretrain":
            return results

    # ---- real data ---------------------------------------------------------
    real = FinetuneDataset(device=device)
    real.load_data(cfg.ft_data_config)
    cfg = real.build_dataset(cfg)
    if trainer is None:  # a resumed stage: the pretrain checkpoint
        trainer = Trainer(cfg, logger)
        trainer.model = _saved_model(cfg, False, device)
        params = trainer.model.state_dict()
    trainer.cfg = cfg

    # the ground truth's own collision counts on the test window (the
    # "Real" calibration row of the paper's tables)
    gt_pos = real.test_data[0].position[cfg.skip_frames:]
    results["gt_test"] = {
        "collision": float(collision_count(gt_pos, 0.5)),
        "hard_collision": float(collision_count(gt_pos, 0.25)),
    }

    # the pretrained model judged on the held-out real window, once per
    # state file (reference: test_multiple_rollouts on test_data)
    if "pretrain_test" not in results:
        t0 = time.time()
        pre = evaluate_rollouts(trainer.model, cfg, real.test_data,
                                test_flag=True)
        logger.log(stage="pretrain_test_real", **vars(pre))
        results["pretrain_test"] = dict(vars(pre),
                                        eval_wall_s=time.time() - t0)
        write_state(state_path, results)

    # ---- finetune with the differentiable rollout loss ---------------------
    if stage in ("all", "finetune"):
        t0 = time.time()
        ft_state = trainer.finetune(None, real.valid_data, None,
                                    pretrained=params,
                                    train_scenes=real.train_data)
        results["finetune"] = {
            "val_loss": ft_state.best_val, "wall_s": time.time() - t0,
            "epochs_ran": ft_state.epoch + 1,
        }
    else:  # evaluate: the saved finetuned checkpoint
        trainer.model = _saved_model(cfg, True, device)

    ft = evaluate_rollouts(trainer.model, cfg, real.test_data,
                           test_flag=True)
    logger.log(stage="finetune_test", **vars(ft))
    results["finetune_test"] = dict(vars(ft))
    results["total_wall_s"] = (results.get("total_wall_s", 0)
                               + time.time() - t_all)
    write_state(state_path, results)
    return results


def results_table_md(results: dict) -> str:
    """Pretrained-vs-finetuned metric table for RESULTS.md."""
    pre, ft = results["pretrain_test"], results["finetune_test"]
    ptr, ftr = results.get("pretrain", {}), results.get("finetune", {})
    rows = [
        ("rollout MSE", f"{pre['mse']:.4f}", f"{ft['mse']:.4f}"),
        ("rollout MAE (m)", f"{pre['mae']:.4f}", f"{ft['mae']:.4f}"),
        ("Sinkhorn OT", f"{pre['ot']:.4f}", f"{ft['ot']:.4f}"),
        ("MMD", f"{pre['mmd']:.6f}", f"{ft['mmd']:.6f}"),
        ("soft collisions", f"{pre['collision']:.0f}",
         f"{ft['collision']:.0f}"),
        ("hard collisions", f"{pre['hard_collision']:.0f}",
         f"{ft['hard_collision']:.0f}"),
    ]
    out = ["| metric | pretrained | finetuned |", "|---|---|---|"]
    out += [f"| {a} | {b} | {c} |" for a, b, c in rows]
    out.append("")
    gt = results.get("gt_test")
    if gt:
        out.append(f"Ground truth (the real window itself): "
                   f"{gt['collision']:.0f} soft / {gt['hard_collision']:.0f} "
                   f"hard collisions.")
        out.append("")
    out.append(
        f"Pretrain: best val MSE {ptr.get('val_mse', float('nan')):.5f}, "
        f"{ptr.get('epochs_ran', '?')} epochs, {ptr.get('wall_s', 0):.0f} s. "
        f"Finetune: best val loss {ftr.get('val_loss', float('nan')):.4f}, "
        f"{ftr.get('epochs_ran', '?')} epochs, {ftr.get('wall_s', 0):.0f} s."
    )
    return "\n".join(out)

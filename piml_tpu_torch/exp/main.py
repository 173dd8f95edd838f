"""CLI entry point: pretrain → test → finetune → test, and the collision
evaluation (reference pipeline: src/main.py:126-174).

Counterpart of ``piml_tpu/exp/main.py``.  On the GPU::

    python3 -m piml_tpu_torch.exp.main --model pinnsf_bm \\
        --data_config configs/data_configs/gc_pretrain_paper.yaml \\
        --ft_data_config configs/data_configs/gc_finetune_paper.yaml \\
        --finetune_flag 1 [flags...]

:func:`main` runs on ``cuda:0`` and refuses to start without a GPU;
:func:`run` takes the device explicitly (the tests pass ``"cpu"``).  The
process title the JAX package sets (``set_process_title``) is not ported.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Union

import numpy as np
import torch

from piml_tpu_torch.config import PIMLConfig
from piml_tpu_torch.data import FinetuneDataset, PointwiseDataset, VisDataset
from piml_tpu_torch.engine import (engine_config, eval_rollout,
                                   evaluate_rollouts)
from piml_tpu_torch.metrics import collision_count
from piml_tpu_torch.models import (ModelSpec, build_finetune_model,
                                   build_model, pretrain_model_name)
from piml_tpu_torch.train.trainer import Trainer, checkpoint_path, load_params
from piml_tpu_torch.utils import MetricLogger

Device = Union[str, torch.device]


def set_exp_seed(cfg: PIMLConfig) -> None:
    """Seeding (reference: src/main.py:115-123).  Model weights, shuffles
    and dropout derive from ``cfg.seed`` inside the trainer; this seeds
    the global numpy and torch streams for anything else."""
    np.random.seed(cfg.seed)
    torch.manual_seed(cfg.seed)


def run(cfg: PIMLConfig, logger: Optional[MetricLogger] = None,
        device: Device = "cuda:0") -> dict:
    """The pipeline on ``device``: pretrain on ``cfg.data_config``, test,
    and with ``cfg.finetune_flag`` finetune on ``cfg.ft_data_config`` and
    test again.  Returns the headline numbers."""
    logger = logger or MetricLogger()
    set_exp_seed(cfg)
    if cfg.save_configs:
        os.makedirs(cfg.config_dir, exist_ok=True)
        cfg.save(os.path.join(cfg.config_dir,
                              f"config_{cfg.model_name_suffix}.json"))
    start = time.time()
    results = {}

    # ---- pretrain on synthetic data (main.py:134-146) ---------------------
    polar = cfg.training_mode == "polar"
    synthetic = PointwiseDataset(polar=polar, device=device)
    synthetic.load_data(cfg.data_config)
    logger.info("number of training dataset: "
                f"{len(synthetic.raw.get('train', []))}")
    cfg = synthetic.build_dataset(cfg)
    logger.info(f"train {len(synthetic.train_data)}, "
                f"valid {len(synthetic.valid_data)}")

    trainer = Trainer(cfg, logger)
    state = trainer.train_pointwise(synthetic.train_data,
                                    synthetic.valid_data)
    results["pretrain_val"] = state.best_val

    if synthetic.test_data:
        m = evaluate_rollouts(trainer.model, cfg, synthetic.test_data)
        logger.log(test_loss=m.loss, test_mse=m.mse, test_mae=m.mae,
                   test_ot=m.ot, test_mmd=m.mmd, test_coll=m.collision,
                   test_hard_coll=m.hard_collision)
        results["pretrain_test_mae"] = m.mae

    # ---- finetune on real data (main.py:148-155) --------------------------
    if cfg.finetune_flag:
        real = FinetuneDataset(polar=polar, device=device)
        real.load_data(cfg.ft_data_config)
        cfg = real.build_dataset(cfg)
        trainer.cfg = cfg  # real-data feature dims and time unit
        ft_state = trainer.finetune(None, real.valid_data, real.test_data,
                                    pretrained=state.params,
                                    train_scenes=real.train_data,
                                    shuffle=cfg.shuffle)
        results["finetune_val"] = ft_state.best_val

    logger.info(f"Total train time: {time.time() - start:.1f}s")
    results["train_time_s"] = time.time() - start
    return results


def collision_eval(cfg: PIMLConfig, vis_config: str,
                   logger: Optional[MetricLogger] = None,
                   device: Device = "cuda:0") -> List[dict]:
    """Rollout collision counts of the saved model on visualisation scenes
    (reference: src/main.py:159-173)."""
    logger = logger or MetricLogger()
    vis = VisDataset(device=device)
    vis.load_data(vis_config)
    cfg = vis.build_dataset(cfg)
    spec = ModelSpec.from_config(
        cfg, name=None if cfg.finetune_flag else pretrain_model_name(cfg.model))
    model = (build_finetune_model(spec) if cfg.finetune_flag
             else build_model(spec))
    model.load_state_dict(load_params(checkpoint_path(cfg,
                                                      cfg.finetune_flag)))
    model = model.to(device)
    ecfg = engine_config(cfg, retire=True, track_collisions=False,
                         track_labels=False)
    out = []
    for split, datas in vis.dataset.items():
        for data in datas:
            res = eval_rollout(model, ecfg, data, cfg.skip_frames)
            soft = float(collision_count(res.position, 0.5))
            hard = float(collision_count(res.position, 0.25))
            logger.info(f"#collisions soft/hard: {soft} / {hard}")
            out.append({"split": split, "soft": soft, "hard": hard})
    return out


def main(argv=None):
    if not torch.cuda.is_available():
        raise SystemExit("piml_tpu_torch.exp.main runs on a CUDA GPU; none "
                         "is available")
    cfg = PIMLConfig.from_cli(argv)
    logger = MetricLogger(
        jsonl_path=cfg.jsonl_log or f"metrics_{cfg.model_name_suffix}.jsonl")
    try:
        run(cfg, logger, device="cuda:0")
    finally:
        logger.close()


if __name__ == "__main__":
    main()

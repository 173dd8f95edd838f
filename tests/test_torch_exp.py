"""The port's experiment layer and utilities against the JAX package (CPU):
``exp/grid.py``, ``exp/experiment.py``, ``utils/analysis.py``,
``utils/profiling.py`` and ``utils/vis.py``.

Tolerances:
- grid commands, ``results_table_md``, ``rollout_mae_powerlaw``: exact;
- ``run_staged_experiment`` (pretrain → finetune → evaluate, ``pinnsf_bm``
  on scenes cropped from the committed GC scenes, dropout 0, both packages
  starting from the committed pretrained weights on the JAX run's
  datasets): every recorded loss and metric to rtol 1e-4, as
  ``tests/test_torch_train.py::
  test_run_pinnsf_m_pretrain_matches_jax`` holds ``exp.main.run`` (OT and
  MMD with the absolute floors of ``tests/test_torch_metrics.py``); the
  collision counts of the ground truth exactly.  Both packages are given
  the JAX package's rows and windows and start from trained weights
  (``tests/_torch_staged.py`` says why).
"""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch

import _torch_compare  # noqa: F401  (shares the cores between workers)
from _torch_staged import (AGENTS, FINETUNE_SCENE, PRETRAIN_SCENE,
                           assert_state_matches, pin_jax_start,
                           pin_port_start, write_splits)
from piml_tpu.config import PIMLConfig as JaxConfig
from piml_tpu_torch.config import PIMLConfig
from piml_tpu_torch.scene import Scene, crop


# ---------------------------------------------------------------------------
# exp/grid.py
# ---------------------------------------------------------------------------

def test_yaml_to_grid_params_matches_jax(tmp_path):
    """The cartesian product of the list-valued keys, as the JAX package
    builds it, with the port's CLI module."""
    from piml_tpu.exp.grid import yaml_to_grid_params as jax_grid
    from piml_tpu_torch.exp.grid import yaml_to_grid_params

    p = tmp_path / "grid.yaml"
    p.write_text("exp_name: g\nlearning_rate:\n  - 0.1\n  - 0.2\n"
                 "batch_size:\n  - 8\n  - 16\nmodel: pinnsf_bm\n"
                 "finetune_flag: 1\n")
    got = yaml_to_grid_params(str(p))
    ref = jax_grid(str(p))
    assert len(got) == 4
    assert got == [c.replace("-m piml_tpu.exp.main",
                             "-m piml_tpu_torch.exp.main") for c in ref]
    assert all(c.startswith(f"{sys.executable} -m piml_tpu_torch.exp.main ")
               for c in got)
    assert yaml_to_grid_params(str(p), "tool.py") == jax_grid(str(p),
                                                              "tool.py")


def test_task_queue_retries(tmp_path, capsys):
    """A failing command is retried up to ``num_retries`` times, then the
    queue gives up (0); a command that fails once and then succeeds passes
    on its retry (1); ``dry_run`` runs nothing."""
    from piml_tpu_torch.exp.grid import main, task_queue

    assert task_queue(["false"], num_retries=2, interval=0.01) == 0
    assert capsys.readouterr().out.count("Executing: false") == 2
    flag = tmp_path / "once"
    flaky = f"test -f {flag} || {{ touch {flag}; exit 1; }}"
    assert task_queue([flaky, "true"], num_retries=3, interval=0.01) == 1
    assert capsys.readouterr().out.count("Executing") == 3
    assert task_queue(["false"], dry_run=True) == 1
    assert "[dry-run] false" in capsys.readouterr().out
    p = tmp_path / "grid.yaml"
    p.write_text("epochs:\n  - 1\n  - 2\n")
    assert main(["-p", str(p), "--dry_run"]) == 0
    out = capsys.readouterr().out
    assert out.count("-m piml_tpu_torch.exp.main --epochs") == 2


# ---------------------------------------------------------------------------
# exp/experiment.py
# ---------------------------------------------------------------------------

def test_run_staged_experiment_matches_jax(tmp_path, monkeypatch):
    """Three resumed stages, pretrain → finetune → evaluate, on one state
    file in each package (``val_coll_weight`` lowered so that the
    finetune's validation loss can improve on the pretrained model's and
    the finetuned checkpoint differs from it): the pretrain's best
    validation MSE, the pretrained and finetuned models' test metrics, the
    finetune's best validation loss and the ground truth's collisions
    agree; the evaluate stage's reloaded finetuned checkpoint scores what
    the finetune stage scored; the state file carries every stage."""
    from piml_tpu.exp.experiment import run_staged_experiment as jax_staged
    from piml_tpu.utils import MetricLogger as JaxLogger
    from piml_tpu_torch.exp.experiment import (read_state,
                                               run_staged_experiment)
    from piml_tpu_torch.utils import MetricLogger

    splits = dict(train=(0, 80), valid=(80, 120), test=(120, 160))
    kw = dict(model="pinnsf_bm", dataset_name="gc2344", skip_frames=5,
              valid_steps=5, dropout=0.0, batch_size=64, ft_batch_size=8,
              epochs=2, learning_rate=2e-4, weight_decay=1e-6,
              reg_weight=1e-2, collision_pred_weight=5e-2, patience=5,
              ft_patience=5, val_coll_weight=1e-3, exp_name="staged",
              model_name_suffix="s",
              data_config=write_splits(tmp_path, "pre", PRETRAIN_SCENE,
                                       splits),
              ft_data_config=write_splits(tmp_path, "ft", FINETUNE_SCENE,
                                          splits))
    kept = pin_jax_start(monkeypatch)
    quiet = open(os.devnull, "w")
    ref = {}
    for stage in ("pretrain", "finetune", "evaluate"):
        ref = jax_staged(JaxConfig(**kw, save_dir=str(tmp_path / "jax")),
                         stage, str(tmp_path / "jax.json"),
                         JaxLogger(stream=quiet))

    # the port starts from the same weights, on the JAX run's datasets
    pin_port_start(monkeypatch, kept)
    state_path = str(tmp_path / "port.json")
    got = {}
    for stage in ("pretrain", "finetune", "evaluate"):
        got[stage] = run_staged_experiment(
            PIMLConfig(**kw, save_dir=str(tmp_path / "port")), stage,
            state_path, MetricLogger(stream=quiet), device="cpu")
        if stage == "finetune":
            ft_test = dict(got[stage]["finetune_test"])
    res = got["evaluate"]
    assert res == read_state(state_path)
    assert_state_matches(res, ref)
    assert res["pretrain"]["epochs_ran"] == res["finetune"]["epochs_ran"] \
        == 2
    # the evaluate stage reloads the checkpoint the finetune stage scored
    assert res["finetune_test"] == ft_test
    assert res["pretrain_test"]["mse"] != res["finetune_test"]["mse"]


def test_run_staged_experiment_refuses_unknown_stages(tmp_path):
    from piml_tpu_torch.exp.experiment import run_staged_experiment

    with pytest.raises(ValueError, match="stage"):
        run_staged_experiment(PIMLConfig(), "train",
                              str(tmp_path / "s.json"), device="cpu")


def test_results_table_md_matches_jax():
    from piml_tpu.exp.experiment import results_table_md as jax_table
    from piml_tpu_torch.exp.experiment import results_table_md

    metrics = dict(loss=1.5, mse=1.5, mae=0.8123, ot=0.377, mmd=0.00123,
                   collision=12.0, hard_collision=3.0)
    results = {
        "pretrain_test": metrics,
        "finetune_test": dict(metrics, mse=0.9, mae=0.51, collision=4.0),
        "pretrain": {"val_mse": 0.0123, "epochs_ran": 7, "wall_s": 12.3},
        "finetune": {"val_loss": 2.5, "epochs_ran": 3, "wall_s": 45.6},
        "gt_test": {"collision": 2.0, "hard_collision": 0.0},
    }
    assert results_table_md(results) == jax_table(results)
    del results["gt_test"], results["finetune"]
    assert results_table_md(results) == jax_table(results)


# ---------------------------------------------------------------------------
# utils
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("horizon", ["long", "short"])
def test_rollout_mae_powerlaw_matches_jax_bitwise(rng, horizon):
    """The same seeded positions and masks through both copies: bucket
    MAEs and the power-law fit bit for bit (NaN buckets and fits too)."""
    from piml_tpu.utils.analysis import rollout_mae_powerlaw as jax_fn
    from piml_tpu_torch.utils import rollout_mae_powerlaw

    T, N = (200, 12) if horizon == "long" else (40, 5)
    label = rng.randn(T, N, 2).astype(np.float32)
    pred = label + 0.01 * np.cumsum(rng.randn(T, N, 2), 0).astype(np.float32)
    mask = np.zeros((T, N), np.float32)
    for p in range(N):
        a = rng.randint(0, T // 4)
        mask[a:a + rng.randint(T // 2, T - a + 1), p] = 1
    got = rollout_mae_powerlaw(label, pred, mask, 0.08)
    ref = jax_fn(label, pred, mask, 0.08)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1:] == ref[1:] or (all(map(math.isnan, got[1:]))
                                  and all(map(math.isnan, ref[1:])))
    assert np.isfinite(got[0]).all() == (horizon == "long")


def test_trace_to_writes_a_chrome_trace_with_the_annotations(tmp_path):
    from piml_tpu_torch.utils.profiling import annotate, trace_to

    with trace_to(str(tmp_path / "trace")) as prof:
        with annotate("piml_step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(e.key == "piml_step" for e in prof.key_averages())
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "piml_step" for e in events)


def test_vis_frames_render_like_jax(tmp_path):
    """The port's animation draws the artists the JAX package's draws on
    every frame of a scene (Agg backend), and its writers export."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from piml_tpu.scene import Scene as JaxScene
    from piml_tpu.utils import vis as jax_vis
    from piml_tpu_torch.utils import vis

    path = str(tmp_path / "s.npy")
    crop(Scene.load(PRETRAIN_SCENE, device="cpu"), 0, 12, AGENTS).save(path)
    scene, jscene = Scene.load(path, device="cpu"), JaxScene.load(path)
    fig, (ax, jax_ax) = plt.subplots(1, 2)
    actors, jactors = vis._actors(ax, scene), jax_vis._actors(jax_ax, jscene)
    for frame in range(scene.num_steps):
        drawn = vis._update(frame, scene, actors)
        ref = jax_vis._update(frame, jscene, jactors)
        assert len(drawn) == len(ref)
        assert [a.get_text() for a in drawn if hasattr(a, "get_text")] == \
            [a.get_text() for a in ref if hasattr(a, "get_text")]
    plt.close(fig)
    fig, ax = plt.subplots()
    ani = vis.state_animation(ax, scene, movie_file=str(tmp_path / "a.html"))
    assert ani.saved_path.endswith(".html")
    assert (tmp_path / "a.html").stat().st_size > 0
    plt.close(fig)
    fig, ax = plt.subplots()
    assert vis.state_animation_compare(ax, scene, scene) is not None
    plt.close(fig)

"""The closed PIML iteration loop.

Counterpart of ``piml_tpu/exp/iterate.py``.  Reference workflow: pretrain
with analytic-SF message supervision (``pinnsf_interaction='loss'``, v0
constants) → extract per-edge messages → fit the symbolic force law → feed
the fitted v2 constants back as supervision for the next iteration
(src/models/simulators.py:333-341, src/symbolic_regression.py,
src/utils/utils.py:76-100).  The reference runs this loop by hand across
shell invocations (``iter_flag``, ``*_iter0`` datasets); here it is one
function.  Training and extraction run on the data's device, the
fits on the host (numpy + scipy).  On a GPU::

    python3 -m piml_tpu_torch.exp.iterate --data_config data.yaml \\
        --scenario GC --iterations 2 --vector 1 --out loop.json \\
        --model pinnsf_bm --pinnsf_interaction loss [PIMLConfig flags...]

:func:`main` runs on ``cuda:0`` and refuses to start without a GPU;
:func:`piml_loop` takes the device explicitly (the tests pass ``"cpu"``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from piml_tpu_torch.config import PIMLConfig
from piml_tpu_torch.data import PointwiseDataset
from piml_tpu_torch.models import MLAPMParams
from piml_tpu_torch.sr import (
    fit_force_law,
    fit_force_law_mse,
    fit_vector_force_law,
    post_filter,
    prepare_symbolic_regression_data,
    prepare_vector_regression_data,
    symbolic_regression,
)
from piml_tpu_torch.train.trainer import Trainer
from piml_tpu_torch.utils import MetricLogger

Device = Union[str, torch.device]


@dataclasses.dataclass
class IterationResult:
    iteration: int
    val_loss: float
    fit_A: float
    fit_B: float
    fit_C: float
    fit_D: float
    fit_r2: float
    gp_expression: Optional[str] = None  # free-form SR cross-check
    gp_loss: Optional[float] = None
    # joint vector fit of the full 2-D law (all five constants incl. the
    # rotation angle; sr/fit.py::fit_vector_force_law) — needs a
    # bottleneck model's per-edge forces
    vec_A: Optional[float] = None
    vec_B: Optional[float] = None
    vec_C: Optional[float] = None
    vec_D: Optional[float] = None
    vec_theta_deg: Optional[float] = None
    vec_r2: Optional[float] = None

    def mlapm_params(self, tau: float = 0.5,
                     theta: float = 10.0) -> MLAPMParams:
        """MLAPM constants for regeneration: the vector fit when it ran
        (it pins C/D and the rotation angle the magnitude fit cannot see),
        the magnitude fit otherwise."""
        if self.vec_A is not None:
            return MLAPMParams(version="GC", tau=tau, A=self.vec_A,
                               B=self.vec_B, C=self.vec_C, D=self.vec_D,
                               theta=self.vec_theta_deg)
        return MLAPMParams(version="GC", tau=tau, A=self.fit_A, B=self.fit_B,
                           C=self.fit_C, D=self.fit_D, theta=theta)


def fit_extracted(features: np.ndarray, labels: np.ndarray, seed: int,
                  triples: Optional[Tuple[np.ndarray, ...]] = None,
                  gp_check: bool = False,
                  logger: Optional[MetricLogger] = None) -> dict:
    """The fits of one loop turn on extracted arrays, as the JAX
    ``run_iteration`` runs them: the rebalanced magnitude fit (log-linear
    seed → robust direct MSE), with ``gp_check`` the free-form search,
    and with ``triples = (dr, dv, F)`` the joint vector fit on the edges
    above the median force.  Returns the :class:`IterationResult` fields."""
    logger = logger or MetricLogger()
    # features = (r, θ_r, v, θ_v, θ_r², coll); labels = (|F|, θ_F)
    r = features[:, 0]
    cos = np.cos(features[:, 1] - features[:, 3])
    feats_f, mag_f = post_filter(np.stack([r, cos], 1), labels[:, 0],
                                 seed=seed)
    # log-linear seed → robust direct-MSE fit (the log fit is floored by
    # small-magnitude edges; see sr/fit.py::fit_force_law_mse)
    seed_fit = fit_force_law(feats_f[:, 0], feats_f[:, 1], mag_f)
    fit = fit_force_law_mse(feats_f[:, 0], feats_f[:, 1], mag_f,
                            init=seed_fit)
    logger.log(fit_A=fit.A, fit_B=fit.B, fit_C=fit.C, fit_D=fit.D,
               fit_r2=fit.r2)
    out = dict(fit_A=fit.A, fit_B=fit.B, fit_C=fit.C, fit_D=fit.D,
               fit_r2=fit.r2)

    if gp_check:
        best = symbolic_regression(feats_f, mag_f, seed=seed).best()
        out.update(gp_expression=best.expression, gp_loss=float(best.loss))
        logger.log(gp_expression=out["gp_expression"],
                   gp_loss=out["gp_loss"])

    if triples is not None and triples[0].shape[0]:
        dr, dv, F = triples
        mag = np.linalg.norm(F, axis=-1)
        keep = mag > np.percentile(mag, 50)
        vfit = fit_vector_force_law(dr[keep], dv[keep], F[keep])
        vec = dict(vec_A=vfit.A, vec_B=vfit.B, vec_C=vfit.C, vec_D=vfit.D,
                   vec_theta_deg=vfit.theta_deg, vec_r2=vfit.r2)
        logger.log(**vec)
        out.update(vec)
    return out


def run_iteration(
    cfg: PIMLConfig,
    dataset: PointwiseDataset,
    logger: Optional[MetricLogger] = None,
    gp_check: bool = False,
    vector_fit: bool = False,
) -> Tuple[IterationResult, dict]:
    """One loop turn on the dataset's device: train → extract messages →
    fit the force family (:func:`fit_extracted`).

    ``gp_check=True`` additionally runs the free-form symbolic-regression
    search (reference symbolic_regression.py:38-52; PySR when installed,
    the native GP engine otherwise) on the same filtered (r, cosθ) data.
    ``vector_fit=True`` also runs the joint VECTOR fit on the raw per-edge
    (dr, dv, F) triples — recovers C/D/θ the magnitude fit cannot see
    (bottleneck models only).  Logs the extracted edge count and the
    extraction and fit seconds."""
    logger = logger or MetricLogger()
    trainer = Trainer(cfg, logger)
    state = trainer.train_pointwise(dataset.train_data, dataset.valid_data)

    t0 = time.perf_counter()
    features, labels = prepare_symbolic_regression_data(trainer.model,
                                                        dataset.train_data)
    triples = (prepare_vector_regression_data(trainer.model,
                                              dataset.train_data)
               if vector_fit else None)
    t1 = time.perf_counter()
    fields = fit_extracted(features, labels, cfg.seed, triples, gp_check,
                           logger)
    logger.log(extract_edges=int(features.shape[0]),
               vector_edges=int(triples[0].shape[0]) if triples else 0,
               extract_s=t1 - t0, fit_s=time.perf_counter() - t1)
    result = IterationResult(iteration=1 if not cfg.iter_flag else 2,
                             val_loss=state.best_val, **fields)
    return result, state.params


def regenerate_scene(
    mp: MLAPMParams, scenario: str, frames: int, out: str,
    seed: int = 666, time_unit: float = 0.08, device: Device = "cuda:0",
) -> str:
    """Regenerate a synthetic scene on ``device`` by simulating the FITTED
    force law.

    The reference's ``*_iter1`` step (src/main_mlapm.py + the hand-run
    dataset regeneration between SR iterations): the discovered MLAPM
    constants drive the rule-based simulator over a scenario's spawn
    schedule, and the run is packaged as a v2.2 scene the next pretrain
    can load."""
    from piml_tpu_torch.gen import SCENARIOS, SFParams, simulate_mlapm, \
        to_scene

    sched, obstacles = SCENARIOS[scenario](frames, seed=seed, device=device)
    ps, _, act = simulate_mlapm(mp, sched, frames, dt=time_unit,
                                device=device)
    # a badly-fitted law (e.g. B > 0: force GROWS with distance) can blow
    # agents up to inf/NaN; the v2.2 codec rightly rejects NaN raw data.
    # Deactivate an agent from its first non-finite frame onward so the
    # scene stays loadable, and fail loudly if that guts the scene.  As in
    # the JAX package, a slot's NaN frames before it spawns count too, so
    # only the agents present at frame 0 pass this filter (ROADMAP.md).
    ps = ps.cpu().numpy()
    act = act.cpu().numpy().astype(bool)
    bad = ~np.isfinite(ps).all(axis=-1)               # (T, N)
    act = act & ~np.maximum.accumulate(bad, axis=0)
    ps = np.where(np.isfinite(ps), ps, 0.0)
    if act.sum(0).max() < 2:
        raise ValueError(
            f"regenerated scene is degenerate (fitted law unstable: "
            f"A={mp.A:.3g} B={mp.B:.3g} C={mp.C:.3g} D={mp.D:.3g}); "
            f"refusing to write {out}")
    scene = to_scene(SFParams(time_unit=time_unit), sched, obstacles, ps, act,
                     meta={"source": f"piml_tpu_torch mlapm-regen {scenario}",
                           "seed": seed, "A": mp.A, "B": mp.B, "C": mp.C,
                           "D": mp.D, "theta": mp.theta},
                     device=device)
    scene.save(out)
    return out


def piml_loop(
    cfg: PIMLConfig,
    data_config: str,
    iterations: int = 2,
    logger: Optional[MetricLogger] = None,
    regen_scenario: Optional[str] = None,
    regen_frames: int = 750,
    work_dir: Optional[str] = None,
    vector_fit: bool = False,
    device: Device = "cuda:0",
) -> List[IterationResult]:
    """Full loop on ``device``: iteration 0 uses the v0 analytic
    supervision; later iterations set ``iter_flag`` so the v2 fitted family
    supervises.

    With ``regen_scenario`` set, the loop is CLOSED: after each iteration
    the fitted constants regenerate the synthetic training data
    (:func:`regenerate_scene` — one train scene, one valid scene at a
    different spawn seed) and the next iteration pretrains on the
    regenerated scenes instead of re-reading ``data_config``.  This is the
    reference's full discover→simulate→rediscover cycle
    (src/symbolic_regression.py:118-168 + simulators.py:333-341) as one
    call.  Logs the regeneration seconds."""
    import yaml

    logger = logger or MetricLogger()
    results = []
    for it in range(iterations):
        cfg_it = cfg.replace(
            iter_flag=it > 0,
            model_name_suffix=f"{cfg.model_name_suffix}_iter{it}",
        )
        dataset = PointwiseDataset(polar=cfg.training_mode == "polar",
                                   device=device)
        dataset.load_data(data_config)
        cfg_it = dataset.build_dataset(cfg_it)
        result, _ = run_iteration(cfg_it, dataset, logger,
                                  vector_fit=vector_fit)
        result = dataclasses.replace(result, iteration=it)
        results.append(result)
        logger.log(iteration=it, val_loss=result.val_loss)
        if regen_scenario is not None and it + 1 < iterations:
            wd = work_dir or os.path.dirname(os.path.abspath(data_config))
            mp = result.mlapm_params()
            paths = {}
            t0 = time.perf_counter()
            for split, seed in (("train", 1000 + it), ("valid", 2000 + it)):
                out = os.path.join(wd, f"regen_iter{it}_{split}.npy")
                regenerate_scene(mp, regen_scenario, regen_frames, out,
                                 seed=seed, time_unit=cfg.time_unit or 0.08,
                                 device=device)
                paths[split] = [out]
            data_config = os.path.join(wd, f"regen_iter{it}.yaml")
            with open(data_config, "w") as f:
                yaml.safe_dump(paths, f)
            logger.log(regenerated=data_config, regen_A=mp.A, regen_B=mp.B,
                       regen_s=time.perf_counter() - t0)
    return results


def main(argv=None) -> int:
    """One-command closed PIML loop on ``cuda:0``.

    Unrecognized flags pass through to :meth:`PIMLConfig.from_cli`, so the
    loop runs at any budget (paper or smoke)."""
    import argparse
    import json

    if not torch.cuda.is_available():
        raise SystemExit("piml_tpu_torch.exp.iterate runs on a CUDA GPU; "
                         "none is available")
    ap = argparse.ArgumentParser(description="closed PIML discovery loop")
    ap.add_argument("--data_config", required=True,
                    help="iteration-0 pretrain data yaml")
    ap.add_argument("--iterations", type=int, default=2)
    ap.add_argument("--scenario", default=None,
                    help="regenerate data between iterations with the "
                         "fitted MLAPM on this scenario (closes the loop)")
    ap.add_argument("--frames", type=int, default=750)
    ap.add_argument("--work_dir", default=None)
    ap.add_argument("--vector", type=int, default=0,
                    help="also run the joint vector force-law fit "
                         "(bottleneck models)")
    ap.add_argument("--out", default="sr_gc_loop.json")
    args, rest = ap.parse_known_args(argv)

    cfg = PIMLConfig.from_cli(rest)
    results = piml_loop(cfg, args.data_config, iterations=args.iterations,
                        regen_scenario=args.scenario,
                        regen_frames=args.frames, work_dir=args.work_dir,
                        vector_fit=bool(args.vector), device="cuda:0")
    payload = [dataclasses.asdict(r) for r in results]
    with open(args.out, "w") as f:
        json.dump({"config": {"data_config": args.data_config,
                              "scenario": args.scenario,
                              "iterations": args.iterations,
                              "model": cfg.model, "epochs": cfg.epochs},
                   "iterations": payload}, f, indent=2)
    for r in results:
        print(f"iter {r.iteration}: A={r.fit_A:.3f} B={r.fit_B:.3f} "
              f"C={r.fit_C:.4f} D={r.fit_D:.4f} r2={r.fit_r2:.3f} "
              f"val={r.val_loss:.5f}")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Write the JAX package's numbers for the whole 750-frame GC window.

    JAX_PLATFORMS=cpu python tools/make_gc_window_fixture.py [--seeds 6]
        [--perturb 1e-4] [--out PATH]

Runs ``piml_tpu``'s ``make_time_indexed`` → ``evaluate_rollouts`` (with OT
and MMD) on ``repro_work/gc_sf_repro.npy`` at the configuration of the
port's GC-window check (``pinnsf_bm``, ``skip_frames=25``, time unit
0.08 s, the finetuned weights of
``bench_fixtures/pinnsf_bm_gc_finetuned.msgpack``), and the closed-loop
rollout behind it, over the whole window and over its first
``SHORT_FRAMES`` frames (the scene's arrays cut to them before the views
are built, as ``chip_smoke.py`` phase 7 cuts its slice).

The closed loop is chaotic: a change of 1e-6 m in the scene's positions
moves the 750-frame trajectories by metres, and the port and the JAX
package differ by more than that (float32 rounding in another order, and
neighbours whose matmul-expansion distances tie within ~1e-4 m).  So the
tool also measures the JAX package against itself: ``--seeds`` runs with
every scene position moved by a uniform draw of at most ``--perturb`` m
(1e-4 by default), and it records, for each number, the largest deviation
from the unperturbed run.  The readers hold the port to a multiple of that
spread.

It writes ``piml_tpu_torch/fixtures/gc_window_jax.npz`` (numpy only, so the
port's readers need no JAX):

- ``metric_names``; ``metrics`` and ``metrics_short``: loss, mse, mae, ot,
  mmd, collision, hard_collision of the whole window and of its first
  ``SHORT_FRAMES`` frames; ``spread`` and ``spread_short``: each metric's
  largest relative deviation over the perturbed runs;
- ``frames``, ``position`` ``(F, N, 2)`` (NaN where absent) and ``mask``:
  the rolled-out positions at a few frames; ``spread_median``: per frame,
  the largest median position deviation over the perturbed runs (m);
- ``scene_sha256``: the scene file's digest, so that a changed scene is
  caught (``tests/test_torch_engine.py``, ``chip_smoke.py`` phase 7);
- ``perturb``, ``seeds``.

The tool imports the JAX package and runs on a host that has it (the CPU
is enough: ~1 min a run).
"""

import argparse
import hashlib
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(ROOT, "repro_work", "gc_sf_repro.npy")
WEIGHTS = os.path.join(ROOT, "bench_fixtures",
                       "pinnsf_bm_gc_finetuned.msgpack")
OUT = os.path.join(ROOT, "piml_tpu_torch", "fixtures", "gc_window_jax.npz")
CFG = dict(model="pinnsf_bm", dataset_name="gc2344", dropout=0.0,
           skip_frames=25, time_unit=0.08)
FRAMES = (60, 150, 300, 500, 749)
SHORT_FRAMES = 151
METRICS = ("loss", "mse", "mae", "ot", "mmd", "collision", "hard_collision")
PERTURB = 1e-4
T_KEYED = ("position", "velocity", "acceleration", "destination", "dest_idx",
           "mask_p", "mask_v", "mask_a")


def sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def median_gap(a, b):
    """Median distance between two ``(N, 2)`` position sets over the agents
    present in both."""
    both = np.isfinite(a).all(-1) & np.isfinite(b).all(-1)
    return float(np.median(np.linalg.norm(a[both] - b[both], axis=-1)))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=OUT)
    parser.add_argument("--seeds", type=int, default=6)
    parser.add_argument("--perturb", type=float, default=PERTURB)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)

    from flax.serialization import msgpack_restore

    from piml_tpu.config import PIMLConfig
    from piml_tpu.data import make_time_indexed
    from piml_tpu.engine import engine_config, eval_rollout, evaluate_rollouts
    from piml_tpu.models import ModelSpec, build_model
    from piml_tpu.scene import Scene, codec

    cfg = PIMLConfig(**CFG)
    with open(WEIGHTS, "rb") as f:
        params = msgpack_restore(f.read())
    model = build_model(ModelSpec.from_config(cfg))
    ecfg = engine_config(cfg, retire=True, track_collisions=False,
                         track_labels=False)

    def apply_fn(p, pf, of, sf):
        return model.apply(p, pf, of, sf)

    def one_run(arrays):
        data = make_time_indexed(cfg, Scene.from_arrays(arrays))
        whole = evaluate_rollouts(params, apply_fn, cfg, [data],
                                  test_flag=True)
        cut = {k: v[:SHORT_FRAMES] if k in T_KEYED else v
               for k, v in arrays.items()}
        short = evaluate_rollouts(
            params, apply_fn, cfg,
            [make_time_indexed(cfg, Scene.from_arrays(cut))], test_flag=True)
        res = eval_rollout(params, apply_fn, ecfg, data, cfg.skip_frames)
        frames = np.asarray(FRAMES)
        return (np.array([getattr(whole, k) for k in METRICS]),
                np.array([getattr(short, k) for k in METRICS]),
                np.asarray(res.position)[frames].astype(np.float32),
                np.asarray(res.mask_p)[frames].astype(np.float32))

    t0 = time.perf_counter()
    arrays = codec.decode(SCENE)
    metrics, short, position, mask = one_run(arrays)
    spread = np.zeros(len(METRICS))
    spread_short = np.zeros(len(METRICS))
    spread_median = np.zeros(len(FRAMES))
    for seed in range(args.seeds):
        moved = dict(arrays)
        rs = np.random.RandomState(seed)
        moved["position"] = (arrays["position"] + args.perturb * rs.uniform(
            -1, 1, arrays["position"].shape)).astype(np.float32)
        m, s, p, _ = one_run(moved)
        spread = np.maximum(spread, np.abs(m - metrics) / np.abs(metrics))
        spread_short = np.maximum(spread_short,
                                  np.abs(s - short) / np.abs(short))
        spread_median = np.maximum(spread_median, [
            median_gap(p[i], position[i]) for i in range(len(FRAMES))])
        print(f"seed {seed}: spread {np.round(spread, 4).tolist()}, "
              f"short {np.round(spread_short, 4).tolist()}, median gaps "
              f"{np.round(spread_median, 5).tolist()}", flush=True)
    np.savez_compressed(
        args.out, metric_names=np.array(METRICS), metrics=metrics,
        metrics_short=short, spread=spread, spread_short=spread_short,
        frames=np.asarray(FRAMES), short_frames=SHORT_FRAMES,
        position=position, mask=mask, spread_median=spread_median,
        perturb=args.perturb, seeds=args.seeds,
        scene_sha256=np.array(sha256(SCENE)))
    print({k: float(v) for k, v in zip(METRICS, metrics)})
    print(f"wrote {os.path.relpath(args.out, ROOT)} "
          f"({os.path.getsize(args.out)} bytes) in "
          f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()

"""Synthetic-data generation CLI.

Counterpart of ``piml_tpu/exp/generate.py``: regenerates the reference's
``data/synthetic_data`` scenario files with either engine, on ``cuda:0``
(:func:`main` refuses to start without a GPU)::

  python3 -m piml_tpu_torch.exp.generate --scenario GC --frames 750 \\
      --engine socialforce --out gc.npy
  python3 -m piml_tpu_torch.exp.generate --scenario GC --frames 750 \\
      --engine mlapm --out gc_mlapm.npy
"""

from __future__ import annotations

import argparse
import sys

import torch

from piml_tpu_torch.gen import (
    SCENARIOS,
    SFParams,
    simulate,
    simulate_mlapm,
    to_scene,
)
from piml_tpu_torch.models import MLAPMParams


def main(argv=None):
    if not torch.cuda.is_available():
        raise SystemExit("piml_tpu_torch.exp.generate runs on a CUDA GPU; "
                         "none is available")
    device = "cuda:0"
    parser = argparse.ArgumentParser(description="synthetic crowd generation")
    parser.add_argument("--scenario", choices=sorted(SCENARIOS), required=True)
    parser.add_argument("--frames", type=int, default=750)
    parser.add_argument("--engine", choices=["socialforce", "mlapm"],
                        default="socialforce")
    parser.add_argument("--out", required=True)
    parser.add_argument("--seed", type=int, default=666)
    parser.add_argument("--time_unit", type=float, default=0.08)
    # social-force knobs (reference: src/configs/socialforce.yaml)
    parser.add_argument("--desired_speed_intensity", type=float, default=2.0)
    parser.add_argument("--pedped_repulsive_intensity", type=float,
                        default=3.3)
    parser.add_argument("--pedped_repulsive_radius", type=float, default=0.4)
    parser.add_argument("--pedobs_repulsive_intensity", type=float,
                        default=10.0)
    parser.add_argument("--pedobs_repulsive_radius", type=float, default=0.2)
    parser.add_argument("--oversampling", type=int, default=10)
    parser.add_argument("--max_speed_multiplier", type=float, default=1.4)
    parser.add_argument("--sight_angle_ped", type=float, default=90.0)
    # mlapm constants (reference: src/main_mlapm.py:16)
    parser.add_argument("--mlapm_version", default="GC")
    parser.add_argument("--tau", type=float, default=0.5)
    parser.add_argument("--A", type=float, default=7.55)
    parser.add_argument("--B", type=float, default=-3.00)
    parser.add_argument("--C", type=float, default=0.2)
    parser.add_argument("--D", type=float, default=-0.3)
    parser.add_argument("--theta", type=float, default=56.0)
    args = parser.parse_args(argv)

    sched, obstacles = SCENARIOS[args.scenario](args.frames, seed=args.seed,
                                                device=device)
    sf_params = SFParams(
        desired_speed_intensity=args.desired_speed_intensity,
        pedped_repulsive_intensity=args.pedped_repulsive_intensity,
        pedped_repulsive_radius=args.pedped_repulsive_radius,
        pedobs_repulsive_intensity=args.pedobs_repulsive_intensity,
        pedobs_repulsive_radius=args.pedobs_repulsive_radius,
        oversampling=args.oversampling,
        max_speed_multiplier=args.max_speed_multiplier,
        sight_angle_ped=args.sight_angle_ped,
        time_unit=args.time_unit,
    )
    if args.engine == "socialforce":
        ps, _, act = simulate(sf_params, sched, obstacles, args.frames,
                              device=device)
    else:
        mp = MLAPMParams(version=args.mlapm_version, tau=args.tau, A=args.A,
                         B=args.B, C=args.C, D=args.D, theta=args.theta)
        ps, _, act = simulate_mlapm(mp, sched, args.frames,
                                    dt=args.time_unit, device=device)

    scene = to_scene(sf_params, sched, obstacles, ps, act,
                     meta={"source": f"piml_tpu_torch {args.engine} "
                                     f"{args.scenario}",
                           "seed": args.seed},
                     device=device)
    scene.save(args.out)
    print(f"wrote {args.out}: {scene.num_steps} frames, "
          f"{scene.num_pedestrians} pedestrians")
    return 0


if __name__ == "__main__":
    sys.exit(main())

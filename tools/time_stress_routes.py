#!/usr/bin/env python3
"""Dense-stress rollout ms/frame on both selection routes, for one checkout.

    python3 tools/time_stress_routes.py [--root DIR] [--frames 50]

Imports ``piml_tpu_torch`` and ``chip_smoke.py`` from ``DIR`` (default:
this checkout), so that another commit, unpacked with ``git archive``, can
be timed against this one on the same card: one process per checkout, in
turns (parent, current, current, parent).  Drives the dense-stress rollout
of ``chip_smoke.py``'s phases 4-5 (12,685 agents, 4,096 obstacles, trained
``pinnsf_bm``): a warm-up, then ``--frames`` frames with K2 (the default
``NeighborConfig``) and with K1 (``use_grid_topk=False``), a host clock
around each frame loop, ending in a synchronize.  Prints one JSON line with
the card's name and power limit.  Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--frames", type=int, default=50)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_stress_routes: needs a CUDA device")
    import chip_smoke
    from piml_tpu_torch.physics import NeighborConfig

    dev = torch.device("cuda:0")
    sc = chip_smoke.stress_scene(dev)
    _, model = chip_smoke.trained_model(dev)
    ncfg = NeighborConfig()
    ms = {}
    for route, cfg in (("k2", ncfg),
                       ("k1", ncfg._replace(use_grid_topk=False))):
        chip_smoke.stress_rollout(model, sc, cfg, chip_smoke.WARMUP_FRAMES)
        _, wall = chip_smoke.stress_rollout(model, sc, cfg, args.frames)
        ms[route] = wall / args.frames * 1e3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"root": root, "frames": args.frames,
                      "ms_per_frame": ms, "nvidia_smi": smi}), flush=True)


if __name__ == "__main__":
    main()

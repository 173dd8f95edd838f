"""Readings that the limits of a scoring cell (driver ``eval_scoring``)
are set from, at the cell's own size: ``benchmark.calibrate`` compares
positions and accelerations, which an evaluation does not return.

    python3 -m benchmark.calibrate_scoring --workload <name> --seeds 11,12
        [--units 2]

For each seed: the cell's set-up and ``--units`` units of its entry, then

- ``sound``: the program's scores against the plain reference's, as a run
  checks them;
- ``control``: the reference with its model's matrix products in TF32
  (the precision below the configuration's float32 with TF32 off) in the
  program's place, against the reference.

Prints one JSON line per seed.  Needs a CUDA card (``--device cpu`` for a
rehearsal at a small ``--traffic`` override).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell, seed: int, units: int, device) -> dict:
    import torch

    from benchmark import harness
    from benchmark.yardstick import compare_scores

    ctx = harness.Context(cell, seed, device, harness.Device(device))
    sess = harness.load_module("drivers", cell.traffic["driver"]).Session(ctx)
    for _ in range(units):
        sess.unit()
    ctx.dev.sync()
    sample = sorted(sess.sample, key=lambda x: x[0])
    progs, refs = zip(*sess.reference_scores(sample))
    ctrl = [c for _, c in sess.reference_scores(sample, tf32=True)]
    out = {"seed": seed,
           "sound": compare_scores.score_numbers(zip(progs, refs)),
           "control": compare_scores.score_numbers(zip(ctrl, refs)),
           "scores": list(refs)}
    del sess
    if ctx.dev.cuda:
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--units", type=int, default=2)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--traffic", default="{}",
                    help="JSON overrides of the traffic (rehearsals)")
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("calibrate_scoring: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload,
                             traffic_override=json.loads(args.traffic))
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        r = readings(cell, int(s), args.units, device)
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps({"workload": args.workload, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

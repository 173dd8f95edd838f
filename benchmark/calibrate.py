"""Readings that the limits of ``correct`` are set from, at a cell's own size.

    python3 -m benchmark.calibrate --workload <name> --seeds 11,12,13 [--units 8]

For each seed: the cell's set-up and ``--units`` units of its entry, then

- ``sound``: the program against the plain reference, as a run checks it;
- ``control``: the reference with its matrix products in TF32 (the
  precision below the configuration's float32 with TF32 off) in the
  program's place, against the reference;
- training cells only, ``faults``: the reference put in the program's place
  with half of each batch left out (``half``) or one gradient leaf altered
  (``altered``); a step that leaves the state unchanged reads 1 on
  ``change_gap`` by definition and needs no run.

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
    from benchmark.yardstick import compare

    ctx = harness.Context(cell, seed, device, harness.Device(device))
    sess = harness.load_module("drivers", cell.traffic["driver"]).Session(ctx)
    for _ in range(units):
        sess.unit()
    ctx.dev.sync()
    out = {"seed": seed}
    if sess.kind == "sim":
        sample = sorted(sess.sample)
        refs = [r for _, r in sess.reference_pairs(sample)]
        progs = [{"p": p, "a": a} for _, _, p, a in sample]
        ctrl = [r for _, r in sess.reference_pairs(sample, tf32=True)]
        out["sound"] = compare.rollout_numbers(zip(progs, refs))
        out["control"] = compare.rollout_numbers(zip(ctrl, refs))
    else:
        ref = sess.reference_steps()
        out["sound"] = compare.training_numbers(sess.first, ref)
        out["control"] = compare.training_numbers(sess.reference_steps(tf32=True),
                                                  ref)
        out["faults"] = {f: compare.training_numbers(
            sess.reference_steps(fault=f), ref) for f in ("half", "altered")}
    del sess
    if ctx.dev.cuda:
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--units", type=int, default=8)
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
        print("calibrate: no CUDA card", file=sys.stderr)
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

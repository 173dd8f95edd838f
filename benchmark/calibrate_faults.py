"""Readings of a cell's planted faults, at the cell's own size, for its
limits file.

    python3 -m benchmark.calibrate_faults --workload <name> --seeds 11,12 [--units 4]

For each fault of ``tests/faults/<driver>.py`` and each seed: the fault
planted in the program's timed path, the cell's set-up and ``--units``
units of its entry, then the driver's own ``check()`` against the plain
reference.  Prints one JSON line per fault and seed.  Sim cells (their
``check()`` returns the numbers the limits judge); needs a CUDA card
(``--device cpu`` for a rehearsal at a small ``--traffic`` override).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--units", type=int, default=4)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--traffic", default="{}",
                    help="JSON overrides of the traffic (rehearsals)")
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch
    from _pytest.monkeypatch import MonkeyPatch

    from benchmark import harness

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("calibrate_faults: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload,
                             traffic_override=json.loads(args.traffic))
    driver = cell.traffic["driver"]
    path = os.path.join(harness.BENCH, "tests", "faults", driver + ".py")
    spec = importlib.util.spec_from_file_location(f"_faults_{driver}", path)
    faults = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(faults)
    for kind in faults.KINDS:
        for s in args.seeds.split(","):
            t0 = time.perf_counter()
            mp = MonkeyPatch()
            faults.plant(mp, kind)
            try:
                ctx = harness.Context(cell, int(s), device,
                                      harness.Device(device))
                sess = harness.load_module("drivers", driver).Session(ctx)
                for _ in range(args.units):
                    sess.unit()
                ctx.dev.sync()
                numbers = sess.check()
            finally:
                mp.undo()
            print(json.dumps({"workload": args.workload, "fault": kind,
                              "seed": int(s), **numbers,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

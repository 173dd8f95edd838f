"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up (imports, the card's context, the
kernels' build on a checkout's first run, weights, inputs, warm-up) is
timed as ``setup_s``; then the cell's entry runs back to back for
``--seconds``; ``--trace 1`` then profiles a short steady slice for the
per-layer metrics.  The outputs of the window are checked against the
plain reference in ``benchmark/reference/``.  The last line of standard
output is one JSON object; the numbers compared, each beside its limit,
are the last lines of standard error.  Exits non-zero, printing no
result, without a CUDA card, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = os.path.join(ROOT, "build", "bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)

    import torch

    from benchmark import harness

    program = importlib.util.find_spec("piml_tpu_torch")
    if program is None or not program.origin.startswith(ROOT + os.sep):
        print("benchmark: the program piml_tpu_torch is not in this checkout",
              file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: needs {cell.chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    def log(msg):
        print(f"benchmark: {msg}", file=sys.stderr, flush=True)

    res = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda:0"), T_START, log)
    return report(res)


def report(res: dict) -> int:
    """Print a run's result: the numbers compared on standard error, the
    result line last on standard output.  Looks at ``sys.modules`` once
    more first, after the check: where JAX or the JAX package was loaded,
    names it and prints no result."""
    from benchmark import harness

    bad = harness.forbidden_modules()
    if bad:
        print("benchmark: forbidden modules loaded: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    numbers = res.pop("_numbers")
    for c in res["checks"].values():  # strict JSON: no Infinity or NaN
        if not math.isfinite(c["value"]):
            c["value"] = str(c["value"])
    print("benchmark: numbers " + json.dumps(numbers), file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"check correct {res['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())

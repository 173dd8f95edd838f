#!/usr/bin/env python3
"""Time the two neighbour-selection kernels of several checkouts against
each other on one GPU: one process per checkout, in turns.

    python3 tools/time_topk_kernels.py [NAME=]DIR [[NAME=]DIR ...]
        [--reps 50] [--k1-slices 1,2,4,6,8]

Each ``DIR`` is the root of a tree that holds ``piml_tpu_torch/``: this
checkout, another commit (``git archive <commit> piml_tpu_torch | tar -x -C
DIR``), or a copy whose ``csrc`` holds another design.  The runs go in
turns, DIR1 … DIRn then DIRn … DIR1, each in a process of its own that
imports that tree's package, builds its kernels with that tree's
``_build`` and launches them through that tree's wrappers
(``pairwise_topk_cuda``, ``banded_topk_cuda``), so two trees compare
whatever their C entry points.

Each run takes the dense-stress shapes of ``chip_smoke.py`` (12,685 agents,
4,096 obstacles; K2 at C = 1 and at C = 2), holds every pass bit for bit
to that tree's plain version, and times it with ``chip_smoke.queued_ms``
(``--reps`` launches, queued behind a sleep kernel).  The trees must also
agree with each other bit for bit.  ``--k1-slices`` also times K1 at each
given column-slice count, in trees whose K1 takes one
(``pairwise.column_slices``).

Prints one JSON line with the card's name and power limit, then one per
pass with every tree's times in call order.  Needs a CUDA device.
"""

import argparse
import hashlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def digest(out):
    """A hash of a kernel's outputs, to compare trees bit for bit."""
    h = hashlib.sha256()
    for t in out:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def load_chip_smoke():
    """This checkout's ``chip_smoke.py``: its helpers import
    ``piml_tpu_torch`` when called, so they drive the tree's package."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def run_tree(root, reps, k1_slices):
    """One tree's run: a JSON line per pass, ``{"which", "ms", "digest"}``."""
    sys.path.insert(0, root)
    import torch

    import piml_tpu_torch
    if not piml_tpu_torch.__file__.startswith(root + os.sep):
        raise SystemExit(f"piml_tpu_torch came from {piml_tpu_torch.__file__}"
                         f", not from {root}")
    cs = load_chip_smoke()
    from piml_tpu_torch.ops import banded, pairwise
    from piml_tpu_torch.physics import NeighborConfig, heading_direction

    dev = torch.device(cs.DEVICE)
    sc = cs.stress_scene(dev)
    ncfg = NeighborConfig()
    heading = heading_direction(sc["vel"], time_axis=False)

    def timed(which, fn, ref):
        out = fn()
        torch.cuda.synchronize()
        cs.assert_equal(out[0], ref[0], f"{which} dist")
        cs.assert_equal(out[1], ref[1], f"{which} idx")
        print(json.dumps(dict(which=which, ms=cs.queued_ms(fn, reps),
                              digest=digest(out))), flush=True)

    rows = pairwise.pack_rows(sc["pos"], heading)
    for name, objects, k, angle, selfp in (
            ("k1 agents", sc["pos"], ncfg.topk_ped, ncfg.sight_angle_ped,
             True),
            ("k1 obstacles", sc["obstacles"], ncfg.topk_obs,
             ncfg.sight_angle_obs, False)):
        cols = pairwise.pack_cols(objects)
        thr = pairwise.cos_threshold(angle)
        ref = pairwise.pairwise_topk_plain(rows, cols, k, thr, selfp)

        def k1():
            return pairwise.pairwise_topk_cuda(rows, cols, k, thr, selfp)
        timed(name, k1, ref)
        if hasattr(pairwise, "column_slices"):
            for s in k1_slices:
                with mock.patch.object(pairwise, "column_slices",
                                       lambda m, s=s: (s, -(-m // s))):
                    timed(f"{name} slices={s}", k1, ref)

    g = torch.Generator().manual_seed(cs.SEED + 1)
    jitter = [0.05 * torch.randn((cs.N_AGENTS, 2), generator=g)
              for _ in "pv"]
    pos2 = torch.stack([sc["pos"], sc["pos"] + jitter[0].to(dev)])
    head2 = heading_direction(
        torch.stack([sc["vel"], sc["vel"] + jitter[1].to(dev)]),
        time_axis=False)
    n_plain = len(inspect.signature(banded.banded_topk_plain).parameters)
    for chans in (1, 2):
        for name, kw in cs.k2_pass_kwargs(sc, ncfg).items():
            if chans == 1:
                args, _ = cs.banded_args(banded.topk_neighbors_banded,
                                         sc["pos"], heading, **kw)
            else:
                kw = {k: v for k, v in kw.items() if k != "same_objects"}
                args, _ = cs.banded_args(banded.topk_neighbors_banded_batched,
                                         pos2, head2, **kw)
            timed(f"k2 {name} C={chans}",
                  lambda args=args: banded.banded_topk_cuda(*args),
                  banded.banded_topk_plain(*args[:n_plain]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*", help="[NAME=]DIR")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--k1-slices", default="")
    ap.add_argument("--tree", help=argparse.SUPPRESS)  # one tree's run
    args = ap.parse_args()
    slices = [int(s) for s in args.k1_slices.split(",") if s]
    if args.tree:
        run_tree(os.path.abspath(args.tree), args.reps, slices)
        return
    if not args.trees:
        ap.error("name at least one tree")

    trees = {}
    for spec in args.trees:
        name, _, path = spec.rpartition("=")
        path = os.path.abspath(path)
        trees[name or os.path.basename(path)] = path
    order = list(trees) + list(trees)[::-1]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"record": "device", "nvidia_smi": smi}), flush=True)
    passes, failed = {}, set()
    for name in order:
        if name in failed:
            continue
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--tree",
             trees[name], "--reps", str(args.reps), "--k1-slices",
             args.k1_slices], capture_output=True, text=True, timeout=900)
        if out.returncode != 0:     # the other trees' turns still run
            failed.add(name)
            print(json.dumps({"record": "failed", "tree": name,
                              "returncode": out.returncode,
                              "stderr": out.stderr[-3000:]}), flush=True)
        for line in out.stdout.splitlines():
            rec = json.loads(line)
            p = passes.setdefault(rec["which"], {"ms": {}, "digest": {}})
            p["ms"].setdefault(name, []).append(rec["ms"])
            p["digest"].setdefault(name, set()).add(rec["digest"])
    for which, p in passes.items():
        p["ms"] = {n: t for n, t in p["ms"].items() if n not in failed}
        if not p["ms"]:
            continue
        digests = set().union(*(p["digest"][n] for n in p["ms"]))
        if len(digests) != 1:
            raise SystemExit(f"{which}: the trees' results differ")
        print(json.dumps({"record": "pass", "which": which,
                          "bitwise_equal_plain": True,
                          "trees_bitwise_equal": True,
                          "order": [n for n in order if n in p["ms"]],
                          "ms": p["ms"]}), flush=True)


if __name__ == "__main__":
    main()

"""YAML grid search + sweep runner with retry.

Counterpart of ``piml_tpu/exp/grid.py``; the commands default to the port's
CLI, ``-m piml_tpu_torch.exp.main``::

    python3 -m piml_tpu_torch.exp.grid -p sweep.yaml [--dry_run]

Reference: src/utils/grid_search.py (cartesian product of list-valued keys →
CLI invocations) and src/run_experiments.py (task queue polling free GPUs,
retry ≤ num_rty on nonzero exit).  The runner executes the sweep
sequentially on the host's card with the same exit-code retry semantics.
"""

from __future__ import annotations

import itertools
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

MAIN = "-m piml_tpu_torch.exp.main"


def yaml_to_grid_params(input_path: str,
                        script_name: str = MAIN) -> List[str]:
    """Expand list-valued YAML keys into the cartesian product of CLI commands
    (reference: grid_search.py:30-54)."""
    # PyYAML is imported here only, as in data/datasets.py
    import yaml

    with open(input_path) as f:
        data = yaml.safe_load(f)

    fixed = {k: v for k, v in data.items() if not isinstance(v, list)}
    grids = {k: v for k, v in data.items() if isinstance(v, list)}

    cmds = []
    keys = list(grids)
    for combo in itertools.product(*(grids[k] for k in keys)) if keys else [()]:
        parts = [f"{sys.executable} {script_name}"]
        for k, v in fixed.items():
            parts.append(f"--{k} {v}")
        for k, v in zip(keys, combo):
            parts.append(f"--{k} {v}")
        cmds.append(" ".join(parts))
    return cmds


def task_queue(cmds: Sequence[str], num_retries: int = 3,
               interval: float = 5.0, env: Optional[Dict[str, str]] = None,
               dry_run: bool = False) -> int:
    """Run commands sequentially, retrying failures ≤ ``num_retries`` times
    with ``interval``-second backoff (reference: run_experiments.py:26-72).
    Returns 1 on full success, 0 if any command exhausted its retries."""
    for cmd in cmds:
        if dry_run:
            print(f"[dry-run] {cmd}")
            continue
        retry = 0
        while True:
            print(f" ----- Executing: {cmd} ----- ")
            rc = subprocess.call(cmd, shell=True, env=env)
            if rc == 0:
                break
            retry += 1
            if retry >= num_retries:
                print(" -------------- Command failed -------------- ")
                print(cmd)
                return 0
            time.sleep(interval)
    return 1


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="grid-search sweep runner")
    parser.add_argument("-p", "--config_path", required=True)
    parser.add_argument("-s", "--script_name", default=MAIN)
    parser.add_argument("-r", "--num_rty", type=int, default=3)
    parser.add_argument("-i", "--interval", type=float, default=5.0)
    parser.add_argument("--dry_run", action="store_true")
    args = parser.parse_args(argv)
    cmds = yaml_to_grid_params(args.config_path, args.script_name)
    ok = task_queue(cmds, args.num_rty, args.interval, dry_run=args.dry_run)
    print(" -------------- all experiments done -------------- " if ok
          else " -------------- sweep had failures -------------- ")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

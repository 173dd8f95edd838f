"""Resumable training state as ``torch.save`` files.

Counterpart of ``piml_tpu/train/checkpoint.py``, which writes orbax
checkpoints.  The reference persists only a best-validation state dict
(src/models/simulators.py:278-289); a step file here holds the parameters,
the optimizer's ``state_dict()`` and the epoch / patience counters, so an
interrupted run resumes exactly.  Files are ``directory/step_{step}.pt``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch


def _steps(directory: str):
    steps = []
    for name in os.listdir(directory):
        stem = name[5:].removesuffix(".pt") if name.startswith("step_") \
            else ""
        if stem.isdigit():
            steps.append((int(stem), name))
    return sorted(steps)


def _prune_old_steps(directory: str, keep: int) -> None:
    """Drop all but the newest ``keep`` step files: a restore reads only the
    latest, and every file holds a full optimizer state."""
    for _, name in (_steps(directory)[:-keep] if keep else []):
        try:
            os.remove(os.path.join(directory, name))
        except OSError:
            pass


def _to_cpu(obj):
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_train_state(directory: str, step: int, params: Dict[str, Any],
                     opt_state: Dict[str, Any], extra: Optional[dict] = None,
                     keep: int = 2) -> str:
    """Write ``directory/step_{step}.pt`` (tensors moved to the CPU); the
    newest ``keep`` steps are retained (0 = keep all)."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step}.pt")
    payload = {"params": params, "opt_state": opt_state,
               "extra": dict(extra or {})}
    # write-then-rename: an interrupted save never leaves a torn latest step
    torch.save(_to_cpu(payload), path + ".tmp")
    os.replace(path + ".tmp", path)
    _prune_old_steps(directory, keep)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1][0] if steps else None


def restore_train_state(directory: str, step: Optional[int] = None
                        ) -> Optional[Dict[str, Any]]:
    """The latest (or given) step's ``{"params", "opt_state", "extra"}``
    on the CPU; None when there is no checkpoint."""
    directory = os.path.abspath(directory)
    if step is None:
        step = latest_step(directory)
    if step is None:
        return None
    path = os.path.join(directory, f"step_{step}.pt")
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)

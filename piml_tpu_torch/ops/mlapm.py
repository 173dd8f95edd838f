"""MLAPM's all-pairs force law on the card.

The law is ``models/mlapm.py`` ``mlapm_force``: each agent's goal term
minus ``Σ_j where(gate_ij, mag_ij · R(±θ) r̂_ij, 0)`` over every agent
``j``.  Its plain version (``models/mlapm.py`` ``_force``) builds a dozen
``(N, N)`` and ``(N, N, 2)`` pair tensors; the JAX package leaves the same
arithmetic to XLA, which fuses it, so no Pallas kernel replaces it there.

A CUDA tensor takes ``csrc/mlapm_force.cu`` (or raises): one pass over
every pair, each term computed in registers and no pair tensor in device
memory.  The pass is bound by the pairs' arithmetic: a block holds 128
rows, and the columns are split among blocks (:func:`column_splits`) so
that dense crowds fill the card; a second small kernel adds the splits'
partial sums in a fixed order.  The law (raw, GC, UCY, UCY with its
collision gate on the magnitude) is read from ``params.version`` and
``params.ucy_gate_compat``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from piml_tpu_torch import _build

KERNEL = _build.KernelCount()
MAX_SPLITS = 64        # column splits at the most (kMaxSplits)
MIN_SPLIT_COLS = 192   # columns a split walks at the least


def column_splits(n: int) -> Tuple[int, int]:
    """``(splits, cols_per_split)`` of a launch over ``n`` agents: at most
    ``MAX_SPLITS``, none under ``MIN_SPLIT_COLS`` columns unless there is
    one, so a crowd of a few hundred agents takes one split; split ``s``
    walks columns ``[s·cols_per_split, min(n, (s + 1)·cols_per_split))``,
    so the splits cover each column once.  The grid is ``⌈n / 128⌉ ×
    splits`` blocks."""
    splits = max(1, min(MAX_SPLITS, n // MIN_SPLIT_COLS))
    return splits, max(1, -(-n // splits))


def _law(params) -> int:
    """The kernel's template instance for ``params``: 0 raw, 1 GC, 2 UCY,
    3 UCY with ``ucy_gate_compat`` off."""
    if params.version == "raw":
        return 0
    if params.version == "GC":
        return 1
    if params.version == "UCY":
        return 2 if params.ucy_gate_compat else 3
    raise ValueError(f"mlapm_force: unknown law version {params.version!r}")


def mlapm_force_cuda(params, position: torch.Tensor, velocity: torch.Tensor,
                     direction: torch.Tensor, goal: torch.Tensor,
                     radius: float, rotations: Sequence[float]
                     ) -> torch.Tensor:
    """Launch ``csrc/mlapm_force.cu`` on PyTorch's current stream: ``goal −
    Σ_j term_ij`` as ``(N, 2)``.  ``position``, ``velocity``, ``direction``
    (each agent's goal direction) and ``goal`` (its goal term) are ``(N,
    2)`` float32 CUDA tensors; ``rotations`` the 8 floats of
    ``models/mlapm.py`` ``_rotations``."""
    law = _law(params)
    n = position.shape[0] if position.ndim == 2 else -1
    for name, t in (("position", position), ("velocity", velocity),
                    ("direction", direction), ("goal", goal)):
        if t.dtype != torch.float32:
            raise TypeError(f"mlapm_force: {name} must be float32")
        if t.ndim != 2 or t.shape != (n, 2):
            raise ValueError(f"mlapm_force: {name} must be (N, 2) with the "
                             f"position's N, got {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 8:
            raise ValueError(f"mlapm_force: {name} must be contiguous and "
                             f"8-byte aligned")
        if t.device != position.device:
            raise ValueError(f"mlapm_force: {name} is on {t.device}, the "
                             f"position on {position.device}")
    if len(rotations) != 8:
        raise ValueError(f"mlapm_force: {len(rotations)} rotation values, "
                         f"the kernel takes 8")
    if position.device.type != "cuda":
        raise ValueError(f"mlapm_force: the kernel needs CUDA tensors, got "
                         f"{position.device}")
    splits, per = column_splits(n)
    partial = torch.empty((splits, n, 2), dtype=torch.float32,
                          device=position.device)
    out = torch.empty((n, 2), dtype=torch.float32, device=position.device)
    rot = (ctypes.c_float * 8)(*rotations)
    lib = _build.LIBRARY.get()
    status = lib.piml_mlapm_force(
        position.data_ptr(), velocity.data_ptr(), direction.data_ptr(),
        goal.data_ptr(), n, splits, per, law, params.A, params.B, params.C,
        params.D, radius * 2, rot, partial.data_ptr(), out.data_ptr(),
        _build.stream_handle(position.device))
    _build.check(status, "piml_mlapm_force")
    KERNEL.launches += 1
    return out

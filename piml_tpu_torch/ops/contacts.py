"""Contact counts: per agent and frame, the other agents within a distance.

The function is ``collision_detection_single_frame`` of the JAX package
(``piml_tpu/physics/features.py``), which XLA computes over the whole
``(..., N, N)`` pair tensor; no Pallas kernel replaces it there.  Its
semantics, for each threshold: ``count_i = Σ_j where(isnan(d_ij), 0,
(d_ij < thr) − [i = j])`` with ``d_ij = vector_norm(p_j − p_i)`` — NaN
positions count nothing, coincident distinct agents count, and the counts
are exact small integers in f32.

A CPU tensor takes the plain version below, a CUDA tensor
``csrc/contact_counts.cu`` (or raises): one launch counts every frame of the
batch for one or two thresholds and never holds a pair tensor in device
memory.  On the card the kernel is bound by its frames·N² pair tests: a
block holds 64 rows and splits the columns among a few warps
(:func:`column_slices`); a pair is decided on its squared distance against
the least square whose correctly rounded root reaches the threshold, so no
sqrt is taken.  The counts carry no gradient.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from piml_tpu_torch import _build

KERNEL = _build.KernelCount()
MAX_THRESHOLDS = 2
MAX_SLICES = 8       # warps a block of the kernel can hold (kMaxSlices)
MIN_SLICE_COLS = 32  # columns a slice walks at the least
_PAIR_CHUNK = 2 ** 25   # pair elements per chunk of the plain version


@torch.no_grad()
def contact_counts_plain(position: torch.Tensor,
                         threshold: float) -> torch.Tensor:
    """Plain version for one threshold: ``(..., N, 2) → (..., N)``, taken
    ``chunk`` query rows at a time, so at most ``_PAIR_CHUNK`` pairs exist
    at once: the BPTT loss counts label contacts over whole ``(C, T, N)``
    windows, whose pair tensor at dense N would not fit the card."""
    n = position.shape[-2]
    lead = math.prod(position.shape[:-2])
    chunk = max(1, _PAIR_CHUNK // max(lead * n, 1))
    cols = position[..., None, :, :]
    counts = []
    for s in range(0, max(n, 1), chunk):
        rows = position[..., s:s + chunk, None, :]
        dist = torch.linalg.vector_norm(cols - rows, dim=-1)   # ..., r, N
        eye = (torch.arange(s, s + dist.shape[-2], device=position.device
                            )[:, None]
               == torch.arange(n, device=position.device)[None, :])
        hit = (dist < threshold).to(position.dtype) - eye.to(position.dtype)
        counts.append(torch.where(torch.isnan(dist), 0.0, hit).sum(dim=-1))
    return torch.cat(counts, dim=-1)


def column_slices(n: int) -> Tuple[int, int]:
    """``(slices, cols_per_slice)`` of a launch over ``n`` agents:
    ``MAX_SLICES`` warps a block, fewer where a slice would walk under
    ``MIN_SLICE_COLS`` columns; slice ``s`` takes columns
    ``[s·cols_per_slice, min(n, (s + 1)·cols_per_slice))``, so the slices
    cover each column once.  A block holds 64 rows whatever the split, so
    the grid follows ``(frames, N)``: ``frames · ⌈N / 64⌉`` blocks."""
    slices = max(1, min(MAX_SLICES, n // MIN_SLICE_COLS))
    return slices, max(1, -(-n // slices))


def contact_counts_cuda(position: torch.Tensor, thresholds: Sequence[float]
                        ) -> Tuple[torch.Tensor, ...]:
    """Launch ``csrc/contact_counts.cu`` on PyTorch's current stream:
    ``(L, N, 2)`` positions → one ``(L, N)`` count tensor per threshold."""
    thresholds = tuple(float(t) for t in thresholds)
    if position.dtype != torch.float32:
        raise TypeError("contact_counts: position must be float32")
    if position.ndim != 3 or position.shape[-1] != 2:
        raise ValueError(f"contact_counts: position must be (L, N, 2), got "
                         f"{tuple(position.shape)}")
    if not position.is_contiguous() or position.data_ptr() % 8:
        raise ValueError("contact_counts: position must be contiguous and "
                         "8-byte aligned")
    if not 1 <= len(thresholds) <= MAX_THRESHOLDS:
        raise ValueError(f"contact_counts: {len(thresholds)} thresholds, "
                         f"the kernel takes 1 to {MAX_THRESHOLDS}")
    if position.device.type != "cuda":
        raise ValueError(f"contact_counts: the kernel needs CUDA tensors, "
                         f"got {position.device}")
    frames, n = position.shape[0], position.shape[1]
    outs = tuple(torch.empty((frames, n), dtype=torch.float32,
                             device=position.device) for _ in thresholds)
    lib = _build.LIBRARY.get()
    status = lib.piml_contact_counts(
        position.data_ptr(), frames, n, *column_slices(n), len(thresholds),
        thresholds[0], thresholds[-1], outs[0].data_ptr(),
        outs[1].data_ptr() if len(outs) == 2 else None,
        _build.stream_handle(position.device))
    _build.check(status, "piml_contact_counts")
    KERNEL.launches += 1
    return outs


@torch.no_grad()
def contact_counts(position: torch.Tensor, thresholds: Sequence[float]
                   ) -> Tuple[torch.Tensor, ...]:
    """``(..., N, 2)`` positions → one ``(..., N)`` count tensor per
    threshold: the plain version once per threshold for a CPU tensor, one
    kernel launch for a CUDA tensor (which raises rather than fall back)."""
    if position.device.type == "cpu":
        return tuple(contact_counts_plain(position, thr)
                     for thr in thresholds)
    lead, n = position.shape[:-2], position.shape[-2]
    flat = position.reshape(math.prod(lead), n, position.shape[-1])
    flat = flat.contiguous()
    return tuple(c.view(*lead, n)
                 for c in contact_counts_cuda(flat, thresholds))

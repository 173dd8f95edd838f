"""K1: dense field-of-view top-k neighbour selection.

Replaces the Pallas kernel ``piml_tpu/ops/pairwise.py:91`` (``_kernel``,
driven by ``topk_neighbors_pallas``) with ``csrc/pairwise_topk.cu``.  The
semantics are the reference's FOV selection (src/data/data.py:416-447):

- ``d2 = dx·dx + dy·dy`` by direct differencing;
- out of view when ``rel_h < f32(cos(3.14·θ/180)) · max(√d2, 1e-8)``;
- +inf for invalid (non-finite) endpoints; in the same-objects case the
  self pair is pinned to ``(d2, rel_h) = (0, 0)``;
- the k smallest ``(d2, id)`` in lexicographic order, returned as
  ``(√d2, id)``; an empty (+inf) slot gets id 0.

On the card the kernel is bound by its N·M pair arithmetic: a block holds
32 query rows, one per lane, and splits the columns among a few warps
(:func:`column_slices`), each staging its columns through shared memory and
rejecting a pair before the sqrt when it cannot rank; the warps' partial
lists are merged at the end.  A CPU tensor takes the plain version below; a
CUDA tensor launches the kernel, or raises.  Selection carries no
gradient: the wrapper detaches its inputs, as the JAX package's
``lax.stop_gradient`` at the kernel inputs does.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from piml_tpu_torch import _build

KERNEL = _build.KernelCount()
MAX_K = 16
MAX_SLICES = 8        # warps a block of the kernel can hold (kMaxSlices)
SLICES = 4            # column slices of a launch over a wide table
MIN_SLICE_COLS = 512  # columns a slice walks at the least


def cos_threshold(angle_threshold: float) -> float:
    """The FOV threshold ``f32(cos(3.14·θ/180))`` — the literal 3.14 (not
    pi) is what excludes the self pair at θ = 90°."""
    return float(np.float32(math.cos(3.14 * angle_threshold / 180.0)))


def pack_rows(position: torch.Tensor, heading: torch.Tensor,
              ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, 2) agents → (N, 8) ``[x, y, hx, hy, valid, id, 0, 0]``; absent
    agents get zero coordinates and ``valid = 0``.  ``ids``: each row's id
    in the object table's id space (default ``arange(N)``), as f32: exact
    below 2^24."""
    n = position.shape[0]
    valid = torch.isfinite(position).all(dim=-1)
    rows = torch.zeros((n, 8), dtype=torch.float32, device=position.device)
    rows[:, 0:2] = torch.where(valid[:, None], position, 0.0)
    rows[:, 2:4] = torch.where(torch.isfinite(heading), heading, 0.0)
    rows[:, 4] = valid.float()
    rows[:, 5] = (torch.arange(n, dtype=torch.float32, device=position.device)
                  if ids is None else ids.to(torch.float32))
    return rows


def pack_cols(objects: torch.Tensor) -> torch.Tensor:
    """(M, 2) objects → (3, M) ``[x; y; valid]``."""
    valid = torch.isfinite(objects).all(dim=-1)
    obj = torch.where(valid[:, None], objects, 0.0)
    return torch.cat([obj.T, valid.float()[None]], dim=0).contiguous()


def pair_d2(xa, ya, hxa, hya, xb, yb, self_pair, cos_thr: torch.Tensor):
    """Squared distance, +inf where the FOV gate rejects the pair — the
    same operations in the same order as ``pair_d2`` in
    ``csrc/topk_common.cuh``, one PyTorch op each (so nothing fuses into a
    multiply-add)."""
    dx = xb - xa
    dy = yb - ya
    d2 = dx * dx + dy * dy
    rel_h = dx * hxa + dy * hya
    if self_pair is not None:
        d2 = torch.where(self_pair, 0.0, d2)
        rel_h = torch.where(self_pair, 0.0, rel_h)
    out_of_view = rel_h < cos_thr * torch.clamp_min(torch.sqrt(d2), 1e-8)
    return torch.where(out_of_view, math.inf, d2)


@torch.no_grad()
def pairwise_topk_plain(rows: torch.Tensor, cols: torch.Tensor, k: int,
                        cos_thr: float, self_pairs: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: direct differencing of every pair, then a
    stable sort on ``(d2, id)``.  Rows are processed in chunks of at most
    2^24 pairs to bound the working set."""
    n, m = rows.shape[0], cols.shape[1]
    dev = rows.device
    thr = torch.tensor(cos_thr, dtype=torch.float32, device=dev)
    out_d = torch.empty((n, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n, k), dtype=torch.int32, device=dev)
    col_ids = torch.arange(m, device=dev)
    chunk = max(1, (1 << 24) // max(m, 1))
    for s in range(0, n, chunk):
        r = rows[s:s + chunk]
        self_pair = None
        if self_pairs:
            row_ids = torch.arange(s, s + r.shape[0], device=dev)
            self_pair = col_ids[None, :] == row_ids[:, None]
        d2 = pair_d2(r[:, 0:1], r[:, 1:2], r[:, 2:3], r[:, 3:4],
                     cols[0][None, :], cols[1][None, :], self_pair, thr)
        invalid = (r[:, 4:5] < 0.5) | (cols[2][None, :] < 0.5)
        d2 = torch.where(invalid, math.inf, d2)
        d2s, order = torch.sort(d2, dim=1, stable=True)
        top = d2s[:, :k]
        out_d[s:s + r.shape[0]] = torch.sqrt(top)
        out_i[s:s + r.shape[0]] = torch.where(torch.isfinite(top),
                                              order[:, :k], 0).int()
    return out_d, out_i


def column_slices(m: int) -> Tuple[int, int]:
    """``(slices, cols_per_slice)`` of a launch over ``m`` columns:
    ``SLICES`` warps a block, fewer when a slice would walk under
    ``MIN_SLICE_COLS`` columns; slice ``s`` takes columns
    ``[s·cols_per_slice, min(m, (s + 1)·cols_per_slice))``, so the slices
    cover each column once.  Every slice fills a list of its own before
    its k-th distance rejects pairs, so more slices buy occupancy with
    repeated fills.  On an NVIDIA H100 at the dense-stress shape
    (N = 12,685, ~12 warps on each SM at 4 slices) 4 slices were the
    fastest of 1, 2, 4, 6 and 8 over M = 4,096 columns and within 1 % of
    the fastest (6) over M = 12,685 (``tools/time_topk_kernels.py``)."""
    slices = max(1, min(SLICES, m // MIN_SLICE_COLS))
    return slices, -(-m // slices)


def pairwise_topk_cuda(rows: torch.Tensor, cols: torch.Tensor, k: int,
                       cos_thr: float, self_pairs: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/pairwise_topk.cu`` on PyTorch's current stream: blocks
    of 32 rows, their columns split into :func:`column_slices`."""
    n, m = rows.shape[0], cols.shape[1]
    if rows.dtype != torch.float32 or cols.dtype != torch.float32:
        raise TypeError("pairwise_topk: rows and cols must be float32")
    if rows.shape != (n, 8) or cols.shape != (3, m):
        raise ValueError(f"pairwise_topk: bad shapes {tuple(rows.shape)}, "
                         f"{tuple(cols.shape)}")
    if not (rows.is_contiguous() and cols.is_contiguous()):
        raise ValueError("pairwise_topk: rows and cols must be contiguous")
    if cols.device != rows.device:
        raise ValueError("pairwise_topk: rows and cols on different devices")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"pairwise_topk: k={k} outside [1, {MAX_K}]")
    if rows.device.type != "cuda":
        raise ValueError(f"pairwise_topk: the kernel needs CUDA tensors, "
                         f"got {rows.device}")
    lib = _build.LIBRARY.get()
    out_d = torch.empty((n, k), dtype=torch.float32, device=rows.device)
    out_i = torch.empty((n, k), dtype=torch.int32, device=rows.device)
    status = lib.piml_pairwise_topk(
        rows.data_ptr(), n, cols.data_ptr(), m, *column_slices(m), cos_thr,
        int(self_pairs), k, out_d.data_ptr(), out_i.data_ptr(),
        _build.stream_handle(rows.device))
    _build.check(status, "piml_pairwise_topk")
    KERNEL.launches += 1
    return out_d, out_i


def pairwise_topk(rows: torch.Tensor, cols: torch.Tensor, k: int,
                  cos_thr: float, self_pairs: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on packed inputs: the plain version for a CPU tensor, the kernel
    for a CUDA tensor (which raises rather than fall back)."""
    if rows.device.type == "cpu":
        return pairwise_topk_plain(rows, cols, k, cos_thr, self_pairs)
    return pairwise_topk_cuda(rows, cols, k, cos_thr, self_pairs)


def topk_neighbors_pallas(
    position: torch.Tensor,
    heading: torch.Tensor,
    k: int,
    angle_threshold: float,
    objects: Optional[torch.Tensor] = None,
    same_objects: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k in-FOV neighbour ``(dist (N, k'), idx (N, k'))`` of
    ``position`` agents among ``objects`` (default: the agents themselves),
    ``k' = min(k, M)``; the name is the JAX package's."""
    if objects is None:
        objects = position
        same_objects = True
    k_eff = min(k, objects.shape[0])
    rows = pack_rows(position.detach(), heading.detach())
    cols = pack_cols(objects.detach())
    return pairwise_topk(rows, cols, k_eff, cos_threshold(angle_threshold),
                         same_objects)

"""The banded Sinkhorn's iteration on the card.

The iteration is ``metrics/ot_banded.py`` ``sinkhorn_banded``'s: both
clouds cell-sorted on one grid, each 128-row tile of one side against one
window of the other side's sorted table, a half-update per side an
iteration with its exactness proof, and the transport cost at the end.  Its
plain version (``ot_banded.py`` ``banded_iterations_plain``) builds the
windows' ``(tiles, 128, window)`` pair tensors and takes some 70 PyTorch
operations an iteration over them; the JAX package leaves the same banded
tensors to XLA, so no Pallas kernel replaces it there.

A CUDA tensor takes ``csrc/sinkhorn_banded.cu`` (or raises): each pair's
term is computed in registers from the sorted positions, with an online
logsumexp, and no pair tensor exists in device memory.  At 12,685 agents a
half-update is 16.4 M window terms, 9.3 M of them between valid points,
each one exp and some ten other operations: the pass is bound by the
card's operations.  A tile's window is split into column slices
(:func:`column_slices`) so that the tiles fill the card; a finish kernel
merges the slices in a fixed order and reduces the error, the proof and the
stop gate on the card, so that an iteration is four launches and two calls
give the same bits.  The host reads the gate every ``stop_check``
iterations and the proof once a frame, where the plain version reads them,
and launches each run of ``stop_check`` iterations in one library call.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Tuple

import torch

from piml_tpu_torch import _build

KERNEL = _build.KernelCount()
LANE = 128             # rows a tile, and the unit of a window (kTileRows)
MAX_SLICES = 64        # column slices a window at the most (kMaxSlices)
MIN_SLICE_COLS = 64    # columns of a full window a slice walks at the least
FINISH_THREADS = 256   # rows a block of the finish kernels (kFinishThreads)

# state_f: err, the two sides' largest valid potential, the cost,
# log(max(nx, ny, 2)); state_i: the gate, exact, iterations, side 0's proof,
# the finish kernels' ticket (csrc/sinkhorn_banded.cu StateF / StateI)
_ERR, _WMAX_Y, _COST, _LOG_M = 0, 2, 3, 4
_ACTIVE, _EXACT, _ITERATIONS = 0, 1, 2


@dataclasses.dataclass
class BandedSide:
    """One side of a banded Sinkhorn frame: its rows, cell-sorted and
    padded to whole tiles, and their windows into the other side's sorted
    table.

    ``pos`` (rows, 2) and ``valid`` (rows,) float32; ``consts`` (rows, 4)
    float32: the row's log marginal, −bound², log1p(bound²) and 1 where its
    proof holds whatever the potentials (an invalid row, no excluded point,
    or no valid point on the other side), else 0; ``start`` and ``win_end``
    (rows / 128,) int64: the first lane of each tile's window and the end
    of its true span in the other side's table."""

    pos: torch.Tensor
    valid: torch.Tensor
    consts: torch.Tensor
    start: torch.Tensor
    win_end: torch.Tensor

    @property
    def rows(self) -> int:
        return self.pos.shape[0]


class _Side(ctypes.Structure):
    """``PimlSinkhornSide`` of ``csrc/sinkhorn_banded.cu``, field for
    field."""

    _fields_ = [("pos", ctypes.c_void_p), ("valid", ctypes.c_void_p),
                ("consts", ctypes.c_void_p), ("start", ctypes.c_void_p),
                ("win_end", ctypes.c_void_p), ("pot", ctypes.c_void_p),
                ("rows", ctypes.c_int), ("tiles", ctypes.c_int)]


def column_slices(window: int) -> int:
    """Column slices of each tile's window in a launch: ``window //
    MIN_SLICE_COLS``, 1 to ``MAX_SLICES``.  The kernel cuts the true span of
    each tile's window (its columns before the window's end in the other
    side's table) into that many slices of equal width, so a full window
    gives no slice under ``MIN_SLICE_COLS`` columns unless there is one.
    The grid is ``tiles × slices`` blocks of 128 rows."""
    return max(1, min(MAX_SLICES, window // MIN_SLICE_COLS))


def _check_side(name: str, s: BandedSide, device) -> None:
    rows = s.rows if s.pos.ndim == 2 else -1
    tiles = rows // LANE
    for field, t, dtype, shape, align in (
            ("pos", s.pos, torch.float32, (rows, 2), 8),
            ("valid", s.valid, torch.float32, (rows,), 4),
            ("consts", s.consts, torch.float32, (rows, 4), 16),
            ("start", s.start, torch.int64, (tiles,), 8),
            ("win_end", s.win_end, torch.int64, (tiles,), 8)):
        what = f"banded_sinkhorn: {name}.{field}"
        if t.dtype != dtype:
            raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{what} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"{what} must be contiguous and {align}-byte "
                             f"aligned")
        if t.device != device:
            raise ValueError(f"{what} is on {t.device}, {device} expected")
    if rows < LANE or rows % LANE:
        raise ValueError(f"banded_sinkhorn: {name} has {rows} rows, not a "
                         f"positive multiple of {LANE}")


def banded_iterations_cuda(x: BandedSide, y: BandedSide, window: int,
                           eps: float, max_iter: int, thresh: float,
                           log_m_terms: torch.Tensor, exact: torch.Tensor,
                           log_tol: float, stop_check: int
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Launch ``csrc/sinkhorn_banded.cu`` on PyTorch's current stream: the
    Sinkhorn iteration from zero potentials on the windows of ``x``'s rows
    in ``y``'s table and of ``y``'s in ``x``'s, then the transport cost.
    ``log_m_terms`` is log(max(nx, ny, 2)) and ``exact`` the windows' own
    proof, both 0-dim; the iteration stops once the error of ``x``'s
    potential falls under ``thresh``, read on the host every
    ``stop_check`` iterations.  Returns ``(cost, exact, iterations)`` as
    0-dim device tensors."""
    dev = x.pos.device
    _check_side("x", x, dev)
    _check_side("y", y, dev)
    if window < LANE or window % LANE:
        raise ValueError(f"banded_sinkhorn: window {window} is not a "
                         f"positive multiple of {LANE}")
    for name, t in (("log_m_terms", log_m_terms), ("exact", exact)):
        if t.ndim != 0 or t.device != dev:
            raise ValueError(f"banded_sinkhorn: {name} must be 0-dim on "
                             f"{dev}")
    if dev.type != "cuda":
        raise ValueError(f"banded_sinkhorn: the kernel needs CUDA tensors, "
                         f"got {dev}")
    slices = column_slices(window)
    rows = max(x.rows, y.rows)
    part = torch.empty((slices, rows, 2), dtype=torch.float32, device=dev)
    blk = torch.empty((-(-rows // FINISH_THREADS), 4), dtype=torch.float32,
                      device=dev)
    u = torch.zeros(x.rows, dtype=torch.float32, device=dev)
    v = torch.zeros(y.rows, dtype=torch.float32, device=dev)
    state_f = torch.zeros(5, dtype=torch.float32, device=dev)
    state_f[_ERR] = math.inf
    # the first half's proof reads the largest valid v, all 0 at the start
    state_f[_WMAX_Y] = torch.where(y.valid > 0.5, 0.0, -math.inf).max()
    state_f[_LOG_M] = log_m_terms
    state_i = torch.zeros(5, dtype=torch.int32, device=dev)
    state_i[_ACTIVE] = 1
    state_i[_EXACT] = exact
    sides = (_Side * 2)(*(
        _Side(s.pos.data_ptr(), s.valid.data_ptr(), s.consts.data_ptr(),
              s.start.data_ptr(), s.win_end.data_ptr(), pot.data_ptr(),
              s.rows, s.rows // LANE)
        for s, pot in ((x, u), (y, v))))
    addr = ctypes.addressof(sides)
    # the library refuses scratch shorter than its launches need
    scratch = (state_f.data_ptr(), state_i.data_ptr(), part.data_ptr(),
               part.numel() // 2, blk.data_ptr(), blk.shape[0],
               _build.stream_handle(dev))
    lib = _build.LIBRARY.get()
    # one call a run of stop_check iterations; the card's gate freezes the
    # frame within a run, the host reads it between runs
    for it in range(0, max_iter, stop_check):
        if not bool(state_i[_ACTIVE]):
            break
        run = min(stop_check, max_iter - it)
        status = lib.piml_sinkhorn_iterations(
            addr, run, window, slices, eps, 1.0 / eps, log_tol, thresh,
            *scratch)
        _build.check(status, "piml_sinkhorn_iterations")
        KERNEL.launches += 2 * run
    status = lib.piml_sinkhorn_cost(addr, window, slices, eps, 1.0 / eps,
                                    *scratch)
    _build.check(status, "piml_sinkhorn_cost")
    KERNEL.launches += 1
    return (state_f[_COST], state_i[_EXACT] != 0,
            state_i[_ITERATIONS].long())

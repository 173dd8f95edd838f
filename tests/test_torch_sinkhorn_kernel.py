"""The banded Sinkhorn's CUDA route on the CPU: what surrounds
``csrc/sinkhorn_banded.cu`` (its wrapper ``ops/sinkhorn.py``, its launch
shapes, the layout of what ``metrics/ot_banded.py`` hands it, its C
interface) and the ``scores.ot`` span.  The kernel itself runs only on a
card (``chip_smoke.py`` phase 12 holds it to the plain iteration there);
the plain iteration is held to the JAX package in
``tests/test_torch_metrics.py``.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_compare  # noqa: F401  (shares the cores between workers)
from piml_tpu_torch import _build
from piml_tpu_torch.metrics import metrics as tm
from piml_tpu_torch.metrics import ot_banded as ob
from piml_tpu_torch.ops import sinkhorn
from piml_tpu_torch.utils import profiling

CSRC = Path(_build.__file__).resolve().parent / "csrc"


def _crowd(n, seed=7, extent=None):
    rng = np.random.default_rng(seed)
    extent = extent or 1.8 * np.sqrt(n)
    p = rng.uniform(0, extent, (n, 2)).astype(np.float32)
    q = (p + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    return torch.from_numpy(p), torch.from_numpy(q), torch.ones(n)


def _sides(n=300):
    """The sides ``sinkhorn_banded`` hands its iteration for a crowd of
    ``n``, with the other arguments of the call."""
    got = {}
    plain = ob.banded_iterations_plain

    def spy(x, y, *args):
        got["call"] = (x, y) + args
        return plain(x, y, *args)

    p, q, m = _crowd(n)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ob, "banded_iterations_plain", spy)
        ob.sinkhorn_banded(p, q, m, m)
    return got["call"]


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def test_wrapper_refuses_bad_inputs_before_any_launch(monkeypatch):
    """The kernel's wrapper validates each side's dtypes, shapes and
    layout, the window and the 0-dim scalars, and raises before touching
    the library or counting a launch; a well-formed CPU call is refused
    too (the CUDA route never falls back)."""
    def no_library():
        raise AssertionError("the library was reached")

    monkeypatch.setattr(_build.LIBRARY, "get", no_library)
    x, y, window, *rest = _sides()
    launches = sinkhorn.KERNEL.launches

    def call(x=x, y=y, window=window, rest=rest):
        return sinkhorn.banded_iterations_cuda(x, y, window, *rest)

    def with_(side, **kw):
        fields = dict(pos=side.pos, valid=side.valid, consts=side.consts,
                      start=side.start, win_end=side.win_end)
        fields.update(kw)
        return sinkhorn.BandedSide(**fields)

    with pytest.raises(TypeError):
        call(x=with_(x, pos=x.pos.double()))
    with pytest.raises(TypeError):
        call(y=with_(y, consts=y.consts.half()))
    with pytest.raises(TypeError):
        call(x=with_(x, start=x.start.int()))
    with pytest.raises(ValueError):                 # not (rows, 2)
        call(x=with_(x, pos=torch.zeros((x.rows, 3))))
    with pytest.raises(ValueError):                 # another row count
        call(y=with_(y, valid=y.valid[:-1].contiguous()))
    with pytest.raises(ValueError):                 # another tile count
        call(x=with_(x, win_end=x.win_end[:-1].contiguous()))
    with pytest.raises(ValueError):                 # not contiguous
        call(x=with_(x, consts=x.consts.t().contiguous().t()))
    with pytest.raises(ValueError):                 # not whole tiles
        call(x=with_(x, pos=x.pos[:-1].contiguous(),
                     valid=x.valid[:-1].contiguous(),
                     consts=x.consts[:-1].contiguous()))
    with pytest.raises(ValueError, match="window"):
        call(window=window + 1)
    with pytest.raises(ValueError, match="0-dim"):
        call(rest=[rest[0], rest[1], rest[2], rest[3].reshape(1)] + rest[4:])
    with pytest.raises(ValueError, match="CUDA"):   # well-formed, on the CPU
        call()
    assert sinkhorn.KERNEL.launches == launches


@pytest.mark.parametrize("n, window, slices, blocks", [(300, 384, 6, 18),
                                                       (1200, 640, 10, 100),
                                                       (12685, 1280, 20,
                                                        2000)])
def test_column_slices_give_the_kernel_its_launch_shape(n, window, slices,
                                                        blocks):
    """The window ``ot_banded_params`` gives each crowd, its slice count
    (one a 64 columns of the window) and the grid of tiles × slices: the
    dataset-density crowd's 100 tiles take 2,000 blocks on the card's 132
    SMs."""
    _, w = ob.ot_banded_params(n, n)
    assert w == window
    assert sinkhorn.column_slices(w) == slices
    assert -(-n // ob.LANE) * slices == blocks


@pytest.mark.parametrize("window", [128, 640, 8192, 12800, 65536])
def test_column_slices_stay_within_the_kernels_limits(window):
    """1 to ``MAX_SLICES`` slices, none under ``MIN_SLICE_COLS`` columns of
    a full window unless there is one."""
    slices = sinkhorn.column_slices(window)
    assert 1 <= slices <= sinkhorn.MAX_SLICES
    assert slices == 1 or window // slices >= sinkhorn.MIN_SLICE_COLS


# ---------------------------------------------------------------------------
# what ot_banded hands the kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [300, 1200])
def test_sides_meet_the_kernels_layout(n):
    """Each side ``sinkhorn_banded`` builds is contiguous, aligned and
    shaped as the kernel reads it: the wrapper's checks pass on it, bar
    the device, and its proof column is 0 or 1."""
    x, y, window, *_ = _sides(n)
    for name, side in (("x", x), ("y", y)):
        sinkhorn._check_side(name, side, side.pos.device)
        assert set(side.consts[:, 3].unique().tolist()) <= {0.0, 1.0}
    assert window % ob.LANE == 0


def test_cpu_call_takes_the_plain_iteration(monkeypatch):
    """A CPU frame never reaches the kernel's wrapper, and returns the
    plain iteration's cost, proof and iteration count."""
    def no_kernel(*args):
        raise AssertionError("the kernel's wrapper was reached")

    monkeypatch.setattr(sinkhorn, "banded_iterations_cuda", no_kernel)
    p, q, m = _crowd(1200)
    cost, exact, its = ob.sinkhorn_banded(p, q, m, m, with_iterations=True)
    x, y, *args = _sides(1200)
    ref = ob.banded_iterations_plain(x, y, *args)
    assert torch.equal(cost, ref[0]) and bool(exact) == bool(ref[1])
    assert int(its) == int(ref[2]) and bool(exact)


def test_fallbacks_count_the_frames_the_streaming_kernel_recomputes():
    """A frame whose proof fails (the second cloud 300 m away) is counted
    once in ``KERNEL.fallbacks``; a proven frame is not."""
    p, q, m = _crowd(300)
    before = sinkhorn.KERNEL.fallbacks
    ob.sinkhorn_banded_or_dense(p, q, m, m, block=128)
    assert sinkhorn.KERNEL.fallbacks == before
    ob.sinkhorn_banded_or_dense(p, q + 300.0, m, m, block=128)
    assert sinkhorn.KERNEL.fallbacks == before + 1


# ---------------------------------------------------------------------------
# the C interface
# ---------------------------------------------------------------------------

def _c_params(name):
    src = "\n".join(p.read_text() for p in sorted(CSRC.glob("*.cu")))
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    assert m, f"{name} is not an extern \"C\" entry point of csrc/"
    return [a.strip() for a in m.group(1).split(",")]


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_signatures_match_the_c_entry_points(name):
    """Each entry point's ctypes signature has one type a parameter of its
    C declaration: a pointer for each pointer, an int for each int, a long
    long for each long long, a float for each float."""
    kinds = {_build._P: "pointer", _build._FP: "pointer", _build._I: "int",
             _build._LL: "long", _build._F: "float"}
    want = []
    for p in _c_params(name):
        want.append("pointer" if "*" in p else p.split()[-2])
    assert [kinds[t] for t in _build._SIGNATURES[name]] == want


def test_side_struct_matches_the_kernels():
    """``ops/sinkhorn.py`` ``_Side`` has ``PimlSinkhornSide``'s fields in
    its order: six pointers, then the row and tile counts."""
    src = (CSRC / "sinkhorn_banded.cu").read_text()
    body = re.search(r"struct PimlSinkhornSide \{(.*?)\};", src, re.S)[1]
    fields = re.findall(r"^\s*([\w ]+?)\s*(\*?)\s*(\w+);", body, re.M)
    want = [(f, "pointer" if star else kind.split()[-1])
            for kind, star, f in fields]
    got = [(f, "pointer" if t is ctypes.c_void_p else "int")
           for f, t in sinkhorn._Side._fields_]
    assert got == want
    assert ctypes.sizeof(sinkhorn._Side) == 6 * 8 + 2 * 4


@pytest.mark.parametrize("c_name, py_name", [("kTileRows", "LANE"),
                                             ("kMaxSlices", "MAX_SLICES"),
                                             ("kFinishThreads",
                                              "FINISH_THREADS")])
def test_wrapper_sizes_match_the_kernels(c_name, py_name):
    """The wrapper sizes its tiles, slices and finish scratch by the
    kernel's own constants (the library also refuses short scratch)."""
    src = (CSRC / "sinkhorn_banded.cu").read_text()
    value = re.search(r"constexpr int " + c_name + r" = (\d+);", src)[1]
    assert int(value) == getattr(sinkhorn, py_name)


# ---------------------------------------------------------------------------
# the scores.ot span
# ---------------------------------------------------------------------------

def test_ot_opens_one_span_a_live_frame_above_the_dense_limit():
    """Above ``dense_limit`` each live frame's banded Sinkhorn is one device
    span ``scores.ot``; a frame with one present agent or none counts 0
    and opens none; below the limit the batched Sinkhorn opens none."""
    g = torch.Generator().manual_seed(5)
    frames, n = 4, 300
    p = torch.rand((frames, n, 2), generator=g) * 30.0
    q = p + 0.5 * torch.randn(p.shape, generator=g)
    mask = torch.ones((frames, n))
    mask[1] = 0.0
    mask[3, 1:] = 0.0                       # one present agent: dead
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            banded = tm.ot_with_time_mask(p, q, mask, "sum", dense_limit=256)
        s = profiling.summary()
        assert s["scores.ot"]["count"] == 2
        assert s["scores.ot"]["stream_s"] is None   # no card
        profiling.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            batched = tm.ot_with_time_mask(p, q, mask, "sum")
        assert "scores.ot" not in profiling.summary()
    finally:
        profiling.reset()
    assert float(banded) == pytest.approx(float(batched), rel=1e-4, abs=1e-5)

"""The port's neighbour-selection kernels (piml_tpu_torch/ops) against the
JAX package's Pallas kernels, run in interpret mode on the CPU.

On the CPU each wrapper takes its kernel's plain PyTorch version.  The
tolerances:

- indices must be equal wherever the JAX distance is finite, and both
  sides must agree on which slots are +inf;
- distances agree to rtol 1e-6, not bitwise: XLA on the CPU contracts
  ``dx*dx + dy*dy`` into a fused multiply-add and its sqrt is not
  correctly rounded, while the port (and its CUDA kernel, built with
  --fmad=false) rounds every operation;
- an empty (+inf) slot carries index 0 in the port; the JAX kernels write
  an arbitrary id there, so those indices are not compared.
"""

import dataclasses
import math
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from piml_tpu.ops.banded import topk_neighbors_banded as jax_banded
from piml_tpu.ops.grid_pairs import build_cell_index as jax_cell_index
from piml_tpu.ops.pairwise import topk_neighbors_pallas as jax_dense
from piml_tpu.physics.features import heading_direction as jax_heading
from piml_tpu_torch import _build
from piml_tpu_torch.models import mlapm as mlapm_model
from piml_tpu_torch.ops import banded, contacts, grid_pairs, mlapm, pairwise
from piml_tpu_torch.scene import codec


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _heading(vel):
    return np.array(jax_heading(jnp.asarray(vel), time_axis=False))


def assert_selection_close(d_jax, i_jax, d_port, i_port):
    d_jax, i_jax = np.asarray(d_jax), np.asarray(i_jax)
    d_port, i_port = d_port.numpy(), i_port.numpy()
    assert d_jax.shape == d_port.shape
    fin = np.isfinite(d_jax)
    np.testing.assert_array_equal(np.isfinite(d_port), fin)
    np.testing.assert_array_equal(i_port[fin], i_jax[fin])
    np.testing.assert_allclose(d_port[fin], d_jax[fin], rtol=1e-6, atol=0)
    assert (i_port[~fin] == 0).all()


def _lattice(side=40, spacing=2.0):
    xs, ys = np.meshgrid(np.arange(side), np.arange(side))
    pos = np.stack([xs.ravel(), ys.ravel()], 1).astype(np.float32) * spacing
    heading = np.tile(np.array([[1.0, 0.0]], np.float32), (pos.shape[0], 1))
    return pos, heading


# ---------------------------------------------------------------------------
# K1: dense selection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,absent", [(64, 0.0), (300, 0.3), (513, 0.1)])
def test_k1_plain_matches_jax_kernel(rng, n, absent):
    pos = rng.randn(n, 2).astype(np.float32) * 5
    pos[rng.rand(n) < absent] = np.nan
    h = _heading(rng.randn(n, 2).astype(np.float32))
    d_j, i_j = jax_dense(jnp.asarray(pos), jnp.asarray(h), 6, 90.0,
                         interpret=True)
    d_t, i_t = pairwise.topk_neighbors_pallas(_t(pos), _t(h), 6, 90.0)
    assert_selection_close(d_j, i_j, d_t, i_t)


def test_k1_plain_separate_objects_matches_jax_kernel(rng):
    n, m = 200, 300
    pos = rng.randn(n, 2).astype(np.float32) * 10
    obs = rng.randn(m, 2).astype(np.float32) * 10
    obs[rng.rand(m) < 0.2] = np.nan
    h = _heading(rng.randn(n, 2).astype(np.float32))
    d_j, i_j = jax_dense(jnp.asarray(pos), jnp.asarray(h), 8, 90.0,
                         objects=jnp.asarray(obs), same_objects=False,
                         interpret=True)
    d_t, i_t = pairwise.topk_neighbors_pallas(_t(pos), _t(h), 8, 90.0,
                                              objects=_t(obs),
                                              same_objects=False)
    assert_selection_close(d_j, i_j, d_t, i_t)


@pytest.mark.parametrize("angle", [90.0, 180.0])
def test_k1_plain_lattice_ties_match_jax_kernel(angle):
    """Integer lattice: distances tie in groups; ties go to the lowest
    object id on both sides (at 180° the self pair is in view)."""
    pos, h = _lattice()
    d_j, i_j = jax_dense(jnp.asarray(pos), jnp.asarray(h), 6, angle,
                         interpret=True)
    d_t, i_t = pairwise.topk_neighbors_pallas(_t(pos), _t(h), 6, angle)
    assert_selection_close(d_j, i_j, d_t, i_t)


def test_k1_plain_k_wider_than_table(rng):
    """k > M gives min(k, M) columns, as the reference's sort + [:k]."""
    pos = rng.randn(20, 2).astype(np.float32)
    obs = rng.randn(4, 2).astype(np.float32)
    h = _heading(rng.randn(20, 2).astype(np.float32))
    d_j, i_j = jax_dense(jnp.asarray(pos), jnp.asarray(h), 10, 90.0,
                         objects=jnp.asarray(obs), same_objects=False,
                         interpret=True)
    d_t, i_t = pairwise.topk_neighbors_pallas(_t(pos), _t(h), 10, 90.0,
                                              objects=_t(obs),
                                              same_objects=False)
    assert d_t.shape == (20, 4)
    assert_selection_close(d_j, i_j, d_t, i_t)


def test_k1_wrapper_refuses_bad_inputs_before_any_launch():
    """The CUDA route validates its inputs and never falls back to the
    plain version; on malformed tensors it raises before touching the
    library."""
    rows = torch.zeros((5, 8))
    with pytest.raises(ValueError):
        pairwise.pairwise_topk_cuda(rows, torch.zeros((2, 5)), 3, 0.1, True)
    with pytest.raises(TypeError):
        pairwise.pairwise_topk_cuda(rows.double(), torch.zeros((3, 5)), 3,
                                    0.1, True)
    with pytest.raises(ValueError):
        pairwise.pairwise_topk_cuda(rows, torch.zeros((3, 5)), 17, 0.1, True)
    with pytest.raises(ValueError, match="CUDA"):   # well-formed, on the CPU
        pairwise.pairwise_topk_cuda(rows, torch.zeros((3, 5)), 3, 0.1, True)



def test_contacts_wrapper_refuses_bad_inputs_before_any_launch(monkeypatch):
    """The contact-count kernel's wrapper validates dtype, shape, layout
    and the number of thresholds, and raises before touching the library
    or counting a launch; a well-formed CPU tensor is refused too (the
    CUDA route never falls back)."""
    def no_library():
        raise AssertionError("the library was reached")

    monkeypatch.setattr(_build.LIBRARY, "get", no_library)
    pos = torch.zeros((2, 5, 2))
    launches = contacts.KERNEL.launches
    with pytest.raises(TypeError):
        contacts.contact_counts_cuda(pos.double(), (0.5,))
    with pytest.raises(ValueError):                 # no frame axis
        contacts.contact_counts_cuda(pos[0], (0.5,))
    with pytest.raises(ValueError):                 # not (x, y)
        contacts.contact_counts_cuda(torch.zeros((2, 5, 3)), (0.5,))
    with pytest.raises(ValueError):                 # not contiguous
        contacts.contact_counts_cuda(
            torch.zeros((2, 2, 5)).transpose(1, 2), (0.5,))
    with pytest.raises(ValueError):
        contacts.contact_counts_cuda(pos, ())
    with pytest.raises(ValueError):
        contacts.contact_counts_cuda(pos, (0.5, 0.25, 0.1))
    with pytest.raises(ValueError, match="CUDA"):   # well-formed, on the CPU
        contacts.contact_counts_cuda(pos, (0.5, 0.25))
    assert contacts.KERNEL.launches == launches


@pytest.mark.parametrize("n", [0, 1, 31, 64, 337, 12685, 100003])
def test_contact_column_slices_cover_each_column_once(n):
    """The contact kernel's slice split: 1 to ``MAX_SLICES`` warps, none
    under ``MIN_SLICE_COLS`` columns unless there is one, and the slices
    ``[s·per, min(n, (s + 1)·per))`` cover each column exactly once."""
    slices, per = contacts.column_slices(n)
    assert 1 <= slices <= contacts.MAX_SLICES
    assert per >= 1 and slices * per >= n
    assert slices == 1 or per >= contacts.MIN_SLICE_COLS
    hits = np.zeros(n, np.int64)
    for s in range(slices):
        hits[s * per:min(n, (s + 1) * per)] += 1
    np.testing.assert_array_equal(hits, 1)

# ---------------------------------------------------------------------------
# MLAPM's all-pairs force law
# ---------------------------------------------------------------------------

def test_mlapm_wrapper_refuses_bad_inputs_before_any_launch(monkeypatch):
    """The force-law kernel's wrapper validates dtype, shape, layout, the
    device, the rotation table and the law's version, and raises before
    touching the library or counting a launch; a well-formed CPU call is
    refused too (the CUDA route never falls back)."""
    def no_library():
        raise AssertionError("the library was reached")

    monkeypatch.setattr(_build.LIBRARY, "get", no_library)
    gc = mlapm_model.MLAPMParams.gc_paper()
    x = torch.zeros((5, 2))
    rot = (1.0, 0.0) * 4
    launches = mlapm.KERNEL.launches

    def call(params=gc, pos=x, vel=x, rotations=rot):
        return mlapm.mlapm_force_cuda(params, pos, vel, x, x, 0.3, rotations)

    with pytest.raises(TypeError):
        call(pos=x.double())
    with pytest.raises(TypeError):
        call(vel=x.half())
    with pytest.raises(ValueError):                 # not (N, 2)
        call(pos=torch.zeros((5, 3)))
    with pytest.raises(ValueError):                 # no agent axis
        call(pos=torch.zeros(2))
    with pytest.raises(ValueError):                 # another N
        call(vel=torch.zeros((4, 2)))
    with pytest.raises(ValueError):                 # not contiguous
        call(vel=torch.zeros((2, 5)).t())
    with pytest.raises(ValueError, match="rotation"):
        call(rotations=rot[:6])
    with pytest.raises(ValueError, match="version"):
        call(params=dataclasses.replace(gc, version="SF"))
    with pytest.raises(ValueError, match="CUDA"):   # well-formed, on the CPU
        call()
    assert mlapm.KERNEL.launches == launches


@pytest.mark.parametrize("n", [0, 1, 7, 337, 3000, 12685, 100003])
def test_mlapm_column_splits_cover_each_column_once(n):
    """The force-law kernel's column split: 1 to ``MAX_SPLITS`` splits,
    none under ``MIN_SPLIT_COLS`` columns unless there is one (a single
    split for the demo's 7 agents and the GC scene's 337 slots), and the
    splits ``[s·per, min(n, (s + 1)·per))`` cover each column exactly
    once."""
    splits, per = mlapm.column_splits(n)
    assert 1 <= splits <= mlapm.MAX_SPLITS
    assert per >= 1 and splits * per >= n
    assert splits == 1 or per >= mlapm.MIN_SPLIT_COLS
    assert splits == 1 or n > 337
    hits = np.zeros(n, np.int64)
    for s in range(splits):
        hits[s * per:min(n, (s + 1) * per)] += 1
    np.testing.assert_array_equal(hits, 1)


@pytest.mark.parametrize("version", ["raw", "GC", "UCY"])
def test_mlapm_cpu_call_takes_the_plain_version(rng, version):
    """A CPU call of ``mlapm_force`` is the plain version, pair tensors and
    all, and launches nothing."""
    n = 30
    p = torch.from_numpy((rng.rand(n, 2) * 5).astype(np.float32))
    v = torch.from_numpy(rng.randn(n, 2).astype(np.float32))
    dest = torch.from_numpy((rng.rand(n, 2) * 5).astype(np.float32))
    ds = torch.full((n,), 1.3)
    params = mlapm_model.MLAPMParams(version=version)
    launches = mlapm.KERNEL.launches
    got = mlapm_model.mlapm_force(params, p, v, ds, dest)
    assert mlapm.KERNEL.launches == launches
    ed, goal = mlapm_model._goal(params, p, v, ds, dest)
    terms = mlapm_model._pair_terms(params, p, v, ed, 0.3)
    assert terms.shape == (n, n, 2)
    assert torch.equal(got, goal - terms.sum(dim=1))


def test_mlapm_rotations_are_the_plain_rotation_of_each_class():
    """The table the kernel selects from holds, for a cross product > 0,
    < 0, 0 and NaN in that order, the (cos, sin) that the plain version's
    rotation takes for such a pair; the angle where the product is 0 is
    ``θ`` rounded from double, which need not be the float path's ``+θ``."""
    theta = 56.0
    rot = mlapm_model._rotations(theta, torch.device("cpu"))
    assert len(rot) == 8
    cross = torch.tensor([2.5, -1e-30, 0.0, -0.0, math.nan])
    angle = mlapm_model._angle(theta, torch.sign(cross))
    c, s = torch.cos(angle).tolist(), torch.sin(angle).tolist()
    for k, cls in enumerate((0, 1, 2, 2, 3)):
        assert (c[k], s[k]) == rot[2 * cls:2 * cls + 2]
    assert rot[0:2] == (rot[2], -rot[3])

# ---------------------------------------------------------------------------
# K2: banded selection
# ---------------------------------------------------------------------------

def _spread(rng, n, extent):
    pos = (rng.rand(n, 2) * extent).astype(np.float32)
    vel = (extent / 2 - pos) + rng.randn(n, 2).astype(np.float32)
    return pos, _heading(vel)


def _window_overflow(rng):
    # a tight cluster inside a wide scene: the cluster tile's window
    # overflows, so the flag must be False
    n = 600
    pos = (rng.rand(n, 2) * 0.5 + 100.0).astype(np.float32)
    pos[:60] = (rng.rand(60, 2) * 100.0).astype(np.float32)
    h = np.tile(np.array([[1.0, 0.0]], np.float32), (n, 1))
    return pos, h, dict(grid_dim=16, window=128)


def _runaways(rng):
    n = 2000
    pos = (rng.rand(n, 2) * 60.0).astype(np.float32)
    pos[0] = (-4000.0, -4000.0)
    pos[1] = (7000.0, 30.0)
    pos[2] = (30.0, 9000.0)
    h = _heading((30.0 - pos) + rng.randn(n, 2).astype(np.float32))
    return pos, h, dict(dist_threshold=4.0)


def _banded_case(name, rng):
    if name == "lattice_ties":
        pos, h = _lattice()
        return pos, h, 180.0, {}
    if name == "window_overflow":
        pos, h, kw = _window_overflow(rng)
        return pos, h, 90.0, kw
    if name == "runaway_outliers":
        pos, h, kw = _runaways(rng)
        return pos, h, 90.0, kw
    if name == "all_invalid":
        return (np.full((512, 2), np.nan, np.float32),
                np.zeros((512, 2), np.float32), 90.0, {})
    if name == "spread_absent":
        pos, h = _spread(rng, 1500, 60.0)
        pos[rng.rand(1500) < 0.25] = np.nan
        return pos, h, 90.0, {}
    raise ValueError(name)


def _k1_equal_where_exact(d_k2, i_k2, d_k1, i_k1, dist_threshold):
    """An exact banded result equals K1's: everywhere when selection-exact,
    on the in-threshold slots when the dist_threshold clause proved it."""
    d_k2, i_k2, d_k1, i_k1 = (x.numpy() for x in (d_k2, i_k2, d_k1, i_k1))
    if dist_threshold is None:
        np.testing.assert_array_equal(d_k2, d_k1)
        np.testing.assert_array_equal(i_k2, i_k1)
        return
    in_thr = d_k1 <= dist_threshold
    np.testing.assert_array_equal(d_k2 <= dist_threshold, in_thr)
    np.testing.assert_array_equal(d_k2[in_thr], d_k1[in_thr])
    np.testing.assert_array_equal(i_k2[in_thr], i_k1[in_thr])


@pytest.mark.parametrize("case", ["lattice_ties", "window_overflow",
                                  "runaway_outliers", "all_invalid",
                                  "spread_absent"])
def test_k2_plain_matches_jax_kernel(rng, case):
    pos, h, angle, kw = _banded_case(case, rng)
    d_j, i_j, ex_j = jax_banded(jnp.asarray(pos), jnp.asarray(h), 6, angle,
                                interpret=True, **kw)
    d_t, i_t, ex_t = banded.topk_neighbors_banded(_t(pos), _t(h), 6, angle,
                                                  **kw)
    assert bool(ex_t) == bool(ex_j)
    assert_selection_close(d_j, i_j, d_t, i_t)
    if bool(ex_t):
        d1, i1 = pairwise.topk_neighbors_pallas(_t(pos), _t(h), 6, angle)
        _k1_equal_where_exact(d_t, i_t, d1, i1, kw.get("dist_threshold"))
    if case == "window_overflow":
        assert not bool(ex_t)


def test_k2_plain_separate_objects_matches_jax_kernel(rng):
    n, m = 700, 3000
    pos, h = _spread(rng, n, 50.0)
    obs = (rng.rand(m, 2) * 50.0).astype(np.float32)
    obs[rng.rand(m) < 0.1] = np.nan
    d_j, i_j, ex_j = jax_banded(jnp.asarray(pos), jnp.asarray(h), 10, 90.0,
                                objects=jnp.asarray(obs), same_objects=False,
                                interpret=True)
    d_t, i_t, ex_t = banded.topk_neighbors_banded(
        _t(pos), _t(h), 10, 90.0, objects=_t(obs), same_objects=False)
    assert bool(ex_t) and bool(ex_j)
    assert_selection_close(d_j, i_j, d_t, i_t)
    d1, i1 = pairwise.topk_neighbors_pallas(_t(pos), _t(h), 10, 90.0,
                                            objects=_t(obs),
                                            same_objects=False)
    _k1_equal_where_exact(d_t, i_t, d1, i1, None)


def test_k2_composed_selector_falls_back_and_counts(rng):
    pos, h, kw = _window_overflow(rng)
    sentinel = (torch.full((600, 6), -1.0),
                torch.full((600, 6), -7, dtype=torch.int32))
    before = banded.KERNEL.fallbacks
    d, i = banded.topk_neighbors_banded_or_dense(
        _t(pos), _t(h), 6, 90.0, lambda: sentinel, **kw)
    assert d is sentinel[0] and i is sentinel[1]
    assert banded.KERNEL.fallbacks == before + 1


def test_build_cell_index_matches_jax(rng):
    pos = (rng.rand(3000, 2) * 80.0).astype(np.float32)
    pos[rng.rand(3000) < 0.1] = np.nan
    o_j, off_j, lo_j, cs_j = jax_cell_index(jnp.asarray(pos), 24)
    o_t, off_t, lo_t, cs_t = grid_pairs.build_cell_index(_t(pos), 24)
    # quantile interpolation may differ by an ulp between the frameworks
    np.testing.assert_allclose(lo_t.numpy(), np.asarray(lo_j), rtol=1e-6)
    np.testing.assert_allclose(cs_t.numpy(), np.asarray(cs_j), rtol=1e-6)
    np.testing.assert_array_equal(off_t.numpy(), np.asarray(off_j))
    np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))


def test_k2_wrapper_refuses_bad_inputs_before_any_launch():
    rows = torch.zeros((128, 8))
    cols = torch.zeros((6, 512))
    geo = torch.ones(4)
    ws = torch.zeros(1, dtype=torch.int32)
    off = torch.zeros(18, dtype=torch.int64)
    with pytest.raises(ValueError):   # window runs past the table
        banded.banded_topk_cuda(ws, geo, rows, cols, 512, 4, 6, 0.1, True,
                                off)
    with pytest.raises(ValueError):   # rows not a whole number of tiles
        banded.banded_topk_cuda(ws, geo, rows[:100].contiguous(), cols, 128,
                                4, 6, 0.1, True, off)
    with pytest.raises(TypeError):
        banded.banded_topk_cuda(ws.long(), geo, rows, cols, 128, 4, 6, 0.1,
                                True, off)
    with pytest.raises(TypeError):    # cell offsets must be int64
        banded.banded_topk_cuda(ws, geo, rows, cols, 128, 4, 6, 0.1, True,
                                off.int())
    with pytest.raises(ValueError):   # offsets of another grid
        banded.banded_topk_cuda(ws, geo, rows, cols, 128, 5, 6, 0.1, True,
                                off)
    with pytest.raises(ValueError, match="CUDA"):   # well-formed, on the CPU
        banded.banded_topk_cuda(ws, geo, rows, cols, 128, 4, 6, 0.1, True,
                                off)


# ---------------------------------------------------------------------------
# the kernels' host-side launch arguments: K2's box ranges, K1's slices
# ---------------------------------------------------------------------------

GC_SCENE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "repro_work", "gc_sf_repro.npy")


def _launch_args(monkeypatch, selector, *args, **kw):
    """The packed arguments a selector hands to ``banded_topk``."""
    seen = []
    real = banded.banded_topk

    def capture(*a):
        seen.append(a)
        return real(*a)

    monkeypatch.setattr(banded, "banded_topk", capture)
    selector(*args, **kw)
    monkeypatch.setattr(banded, "banded_topk", real)
    ws, geo, rows, cols, window, g = seen[0][:6]
    return ws, geo, rows, cols, window, g, seen[0][9]


def _plain_admitted(ws, geo, rows, cols, window, g):
    """``banded_topk_plain``'s mask (valid row, valid column, window, 5×5
    box) spread over the whole table: ``(…, n_pad, m_band)`` booleans."""
    if rows.ndim == 3:
        return torch.stack([
            _plain_admitted(ws[c], geo[c] if geo.ndim == 2 else geo, rows[c],
                            cols[c] if cols.ndim == 3 else cols, window, g)
            for c in range(rows.shape[0])])
    n_pad, mb = rows.shape[0], cols.shape[1]
    tiles = n_pad // banded.TILE_N
    col_idx = ws.long()[:, None] * banded.LANE + torch.arange(window)
    blk = cols[:, col_idx][:, :, None, :]                  # 6, T, 1, W
    r = rows.view(tiles, banded.TILE_N, 8)
    ax = grid_pairs.cell_coords(r[..., 0:1], geo[0], geo[2], g)
    ay = grid_pairs.cell_coords(r[..., 1:2], geo[1], geo[3], g)
    adm = (~(r[..., 4:5] < 0.5) & ~(blk[2] < 0.5)
           & (torch.abs(blk[4] - ax) <= 2.0) & (torch.abs(blk[5] - ay) <= 2.0))
    full = torch.zeros((tiles, banded.TILE_N, mb), dtype=torch.bool)
    full.scatter_(2, col_idx[:, None, :].expand(adm.shape), adm)
    return full.view(n_pad, mb)


def _gc_frame(frame=100):
    d = codec.decode(GC_SCENE)
    pos = np.asarray(d["position"][frame], np.float32)
    vel = np.nan_to_num(np.asarray(d["velocity"][frame], np.float32))
    return pos, _heading(vel), np.asarray(d["obstacles"], np.float32)


def _range_case(name, rng, monkeypatch):
    sel = banded.topk_neighbors_banded
    if name == "stress_agents":
        pos, h = _spread(rng, 1500, 60.0)
        return _launch_args(monkeypatch, sel, _t(pos), _t(h), 6, 90.0,
                            dist_threshold=4.0)
    if name == "stress_obstacles":
        pos, h = _spread(rng, 1500, 60.0)
        obs = (rng.rand(1000, 2) * 60.0).astype(np.float32)
        return _launch_args(monkeypatch, sel, _t(pos), _t(h), 10, 90.0,
                            objects=_t(obs), same_objects=False,
                            dist_threshold=4.0)
    if name in ("gc_agents", "gc_obstacles"):
        pos, h, obs = _gc_frame()
        kw = dict(objects=_t(obs), same_objects=False, dist_threshold=4.0) \
            if name == "gc_obstacles" else dict(dist_threshold=4.0)
        return _launch_args(monkeypatch, sel, _t(pos), _t(h), 6, 90.0, **kw)
    if name == "window_overflow":
        pos, h, kw = _window_overflow(rng)
        return _launch_args(monkeypatch, sel, _t(pos), _t(h), 6, 90.0, **kw)
    if name == "edge_cells":
        pos, h, kw = _runaways(rng)
        return _launch_args(monkeypatch, sel, _t(pos), _t(h), 6, 90.0, **kw)
    if name == "absent_padded":
        pos, h = _spread(rng, 1500, 60.0)
        pos[rng.rand(1500) < 0.25] = np.nan
        obs = (rng.rand(700, 2) * 60.0).astype(np.float32)
        obs[rng.rand(700) < 0.3] = np.nan
        return _launch_args(monkeypatch, sel, _t(pos), _t(h), 10, 90.0,
                            objects=_t(obs), same_objects=False)
    if name in ("batched_agents", "batched_obstacles"):
        pos, h = _two_channels(rng, n=700, extent=40.0)
        obs = _t((rng.rand(900, 2) * 40.0).astype(np.float32)) \
            if name == "batched_obstacles" else None
        return _launch_args(monkeypatch, banded.topk_neighbors_banded_batched,
                            _t(pos), _t(h), 6, 90.0, objects=obs,
                            dist_threshold=4.0)
    raise ValueError(name)


@pytest.mark.parametrize("case", [
    "stress_agents", "stress_obstacles", "gc_agents", "gc_obstacles",
    "window_overflow", "edge_cells", "absent_padded", "batched_agents",
    "batched_obstacles"])
def test_box_ranges_cover_exactly_the_plain_window_box_mask(
        rng, monkeypatch, case):
    """K2's per-row column ranges hold exactly the columns the plain
    version admits (window ∩ 5×5 box ∩ valid, valid rows), each once: on
    random and GC scenes, an overflowed window, boxes clipped at the grid's
    edges, absent agents and obstacles, padded rows and two channels."""
    ws, geo, rows, cols, window, g, offsets = _range_case(case, rng,
                                                          monkeypatch)
    ranges = banded.box_ranges(ws, geo, rows, offsets, window, g)
    assert ranges.dtype == torch.int32
    assert ranges.shape == rows.shape[:-1] + (5, 2)
    lo, hi = ranges[..., 0].long(), ranges[..., 1].long()
    assert (hi >= lo).all() and (lo >= 0).all()
    assert (hi <= cols.shape[-1]).all()
    j = torch.arange(cols.shape[-1])
    inside = ((j >= lo[..., None]) & (j < hi[..., None]))   # …, n, 5, mb
    assert int(inside.sum()) == int((hi - lo).sum())
    got = inside.sum(dim=-2)
    assert int(got.max()) <= 1, "a column lies in two ranges of one row"
    want = _plain_admitted(ws, geo, rows, cols, window, g)
    assert want.any()
    assert torch.equal(got.bool(), want)
    if case == "edge_cells":
        ax = grid_pairs.cell_coords(rows[..., 0], geo[0], geo[2], g)
        valid = rows[..., 4] > 0.5
        assert ((ax[valid] <= 1) | (ax[valid] >= g - 2)).any()
        empty_cols = (lo == hi)[valid]
        assert empty_cols.any()
    if case == "window_overflow":   # the clipping dropped box columns
        whole = banded.box_ranges(torch.zeros_like(ws), geo, rows, offsets,
                                  cols.shape[-1], g)
        assert int((whole[..., 1] - whole[..., 0]).sum()) > int(
            (hi - lo).sum())


@pytest.mark.parametrize("m", [1, 7, 255, 256, 700, 4096, 12685, 100003])
def test_column_slices_cover_each_column_once(m):
    """K1's slice split: at most ``SLICES`` slices (one warp each, within
    the kernel's 8), none under ``MIN_SLICE_COLS`` columns unless there is
    one, and the slices ``[s·per, min(m, (s + 1)·per))`` cover each column
    exactly once."""
    slices, per = pairwise.column_slices(m)
    assert 1 <= slices <= pairwise.SLICES <= pairwise.MAX_SLICES
    assert per >= 1 and slices * per >= m
    assert slices == 1 or per >= pairwise.MIN_SLICE_COLS
    hits = np.zeros(m, np.int64)
    for s in range(slices):
        hits[s * per:min(m, (s + 1) * per)] += 1
    np.testing.assert_array_equal(hits, 1)
    if m >= pairwise.SLICES * pairwise.MIN_SLICE_COLS:
        assert slices == pairwise.SLICES


# ---------------------------------------------------------------------------
# K2 with a channel axis (the BPTT finetune's batched feature pass)
# ---------------------------------------------------------------------------

def _two_channels(rng, n=1536, extent=60.0):
    pos, h = _spread(rng, n, extent)
    pos2 = pos + (0.05 * rng.randn(n, 2)).astype(np.float32)
    pos2[rng.rand(n) < 0.1] = np.nan
    h2 = _heading(rng.randn(n, 2).astype(np.float32))
    return np.stack([pos, pos2]), np.stack([h, h2])


@pytest.mark.parametrize("objects", [False, True])
def test_k2_batched_plain_matches_vmapped_jax_kernel(rng, objects):
    """C = 2 frames at N = 1,536 (past the 2^21 pair gate) through the
    port's batched selector and ``jax.vmap`` of the JAX selector (the
    interpret-mode Pallas kernel batched over channels): agent pass with a
    per-channel cell index, obstacle pass with one shared table."""
    import jax

    pos, h = _two_channels(rng)
    kw = dict(dist_threshold=4.0)
    obs = None
    if objects:
        obs = (rng.rand(2000, 2) * 60.0).astype(np.float32)
        kw["grid_dim"], kw["window"] = banded.banded_params(1536, 2048, 10,
                                                            fine=True)
    k = 10 if objects else 6

    def one(p, hd):
        return jax_banded(p, hd, k, 90.0, interpret=True,
                          objects=None if obs is None else jnp.asarray(obs),
                          same_objects=obs is None, **kw)

    d_j, i_j, ex_j = jax.vmap(one)(jnp.asarray(pos), jnp.asarray(h))
    d_t, i_t, ex_t = banded.topk_neighbors_banded_batched(
        _t(pos), _t(h), k, 90.0, objects=None if obs is None else _t(obs),
        **kw)
    assert d_t.shape == (2, 1536, k) and ex_t.shape == (2,)
    np.testing.assert_array_equal(ex_t.numpy(), np.asarray(ex_j))
    for c in range(2):
        assert_selection_close(d_j[c], i_j[c], d_t[c], i_t[c])


def test_k2_batched_equals_single_frame_calls(rng):
    """Channel for channel, the batched selector is the single-frame one;
    with one channel it makes the single-frame launch."""
    pos, h = _two_channels(rng, n=700, extent=40.0)
    obs = (rng.rand(900, 2) * 40.0).astype(np.float32)
    for objects in (None, _t(obs)):
        got = banded.topk_neighbors_banded_batched(
            _t(pos), _t(h), 6, 90.0, objects=objects, dist_threshold=4.0)
        for c in range(2):
            ref = banded.topk_neighbors_banded(
                _t(pos[c]), _t(h[c]), 6, 90.0, objects=objects,
                same_objects=objects is None, dist_threshold=4.0)
            for a, b in zip(got, ref):
                assert torch.equal(a[c], b)


def test_k2_batched_or_dense_takes_one_decision_for_the_batch(
        rng, monkeypatch):
    """One inexact channel sends the whole batch to the dense path and
    counts one fallback; all exact keeps the banded result."""
    pos, h = _two_channels(rng, n=300, extent=20.0)
    real = banded.topk_neighbors_banded_batched
    flags = {}

    def with_flags(*args, **kw):
        d, i, _ = real(*args, **kw)
        return d, i, torch.tensor(flags["exact"])

    monkeypatch.setattr(banded, "topk_neighbors_banded_batched", with_flags)
    sentinel = (torch.zeros(2, 300, 6), torch.zeros(2, 300, 6,
                                                     dtype=torch.int32))
    for exact, falls_back in (([True, False], True), ([True, True], False)):
        flags["exact"] = exact
        before = banded.KERNEL.fallbacks
        d, _ = banded.topk_neighbors_banded_or_dense(
            _t(pos), _t(h), 6, 90.0, lambda: sentinel)
        assert (d is sentinel[0]) == falls_back
        assert banded.KERNEL.fallbacks == before + int(falls_back)


def test_k2_batched_wrapper_refuses_bad_inputs_before_any_launch():
    rows = torch.zeros((2, 128, 8))
    cols = torch.zeros((2, 6, 512))
    geo = torch.ones(2, 4)
    ws = torch.zeros((2, 1), dtype=torch.int32)
    off = torch.zeros((2, 18), dtype=torch.int64)
    with pytest.raises(ValueError):   # per-channel table for 3 channels
        banded.banded_topk_cuda(ws, geo, rows, torch.zeros((3, 6, 512)), 128,
                                4, 6, 0.1, True, torch.zeros((3, 18),
                                                             dtype=torch.int64))
    with pytest.raises(ValueError):   # window starts for one channel
        banded.banded_topk_cuda(ws[:1], geo, rows, cols, 128, 4, 6, 0.1,
                                True, off)
    with pytest.raises(ValueError):   # per-channel geometry, single frame
        banded.banded_topk_cuda(ws[0], geo, rows[0], cols[0], 128, 4, 6, 0.1,
                                True, off[0])
    with pytest.raises(ValueError):   # shared table, per-channel offsets
        banded.banded_topk_cuda(ws, geo[0], rows, cols[0], 128, 4, 6, 0.1,
                                True, off)
    with pytest.raises(ValueError, match="CUDA"):   # well-formed, shared
        banded.banded_topk_cuda(ws, geo[0], rows, cols[0], 128, 4, 6, 0.1,
                                True, off[0])
    with pytest.raises(ValueError, match="CUDA"):   # well-formed, per channel
        banded.banded_topk_cuda(ws, geo, rows, cols, 128, 4, 6, 0.1, True,
                                off)


# ---------------------------------------------------------------------------
# selection carries no gradient (lax.stop_gradient at the kernel inputs)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["k1", "k2"])
def test_selection_carries_no_gradient_like_jax(rng, which):
    """The JAX selectors stop the gradient at the kernel inputs, so the
    gradient of their distances is zero; the port's wrappers detach their
    inputs and run the plain versions without autograd."""
    import jax

    pos, h = _spread(rng, 600, 30.0)
    if which == "k1":
        def jfn(p):
            return jnp.sum(jnp.where(jnp.isfinite(d := jax_dense(
                p, jnp.asarray(h), 6, 90.0, interpret=True)[0]), d, 0.0))
        tfn = pairwise.topk_neighbors_pallas
    else:
        def jfn(p):
            d = jax_banded(p, jnp.asarray(h), 6, 90.0, interpret=True)[0]
            return jnp.sum(jnp.where(jnp.isfinite(d), d, 0.0))
        tfn = banded.topk_neighbors_banded
    ref = np.asarray(jax.grad(jfn)(jnp.asarray(pos)))
    assert not ref.any()
    p = _t(pos).requires_grad_(True)
    out = tfn(p, _t(h), 6, 90.0)
    assert not any(t.requires_grad for t in out)
    seen = []
    real = (pairwise.pairwise_topk_plain if which == "k1"
            else banded.banded_topk_plain)

    def spy(*args):
        seen.append(any(torch.is_tensor(a) and a.requires_grad
                        for a in args))
        return real(*args)

    mod = pairwise if which == "k1" else banded
    name = "pairwise_topk_plain" if which == "k1" else "banded_topk_plain"
    setattr(mod, name, spy)
    try:
        tfn(p, _t(h), 6, 90.0)
    finally:
        setattr(mod, name, real)
    assert seen and not any(seen)


# ---------------------------------------------------------------------------
# the agent pass's wide fallback: K2 on the half grid
# ---------------------------------------------------------------------------

def _wide_scene(rng, name):
    """``uniform``: the JAX package's scene for its wide-fallback test
    (1,500 agents over 60 m, headed inward), exact on both grids;
    ``cluster``: half the agents within 3 m, whose fine-grid tile windows
    overflow while the half grid's hold them; ``tight_cluster``: 90 %
    within 0.5 m, inexact on both grids (the half-grid result relaxes)."""
    if name == "uniform":
        return _spread(rng, 1500, 60.0)
    frac, size = {"cluster": (0.5, 3.0), "tight_cluster": (0.9, 0.5)}[name]
    n = 1500
    pos = (rng.rand(n, 2) * 100.0).astype(np.float32)
    c = int(n * frac)
    pos[:c] = rng.rand(c, 2) * size + 50.0
    return pos, _heading(rng.randn(n, 2).astype(np.float32))


@pytest.mark.parametrize("name,relaxed", [("uniform", False),
                                          ("cluster", False),
                                          ("tight_cluster", True)])
def test_wide_fallback_matches_jax(rng, name, relaxed):
    """``_banded_wide_fallback`` against the JAX package's (the half-grid
    banded pass, its Pallas kernel in interpret mode), as
    ``tests/test_banded.py::test_huge_m_fallback_is_banded_not_dense``
    runs it: the selections agree whether or not the pass is exact, and
    the port counts the call and, when the flag is false, the relaxation.
    Where the pass is exact its in-threshold slots are K1's."""
    from piml_tpu.physics.features import _banded_wide_fallback as jax_wide
    from piml_tpu_torch.physics import features

    pos, h = _wide_scene(rng, name)
    d_j, i_j = jax_wide(jnp.asarray(pos), jnp.asarray(h), 6, 90.0, 4.0)
    calls, relaxed0 = banded.KERNEL.wide_calls, banded.KERNEL.wide_relaxed
    d_t, i_t = features._banded_wide_fallback(_t(pos), _t(h), 6, 90.0, 4.0)
    assert_selection_close(d_j, i_j, d_t, i_t)
    assert banded.KERNEL.wide_calls == calls + 1
    assert banded.KERNEL.wide_relaxed == relaxed0 + int(relaxed)
    if not relaxed:
        d1, i1 = pairwise.topk_neighbors_pallas(_t(pos), _t(h), 6, 90.0)
        _k1_equal_where_exact(d_t, i_t, d1, i1, 4.0)


@pytest.mark.parametrize("route", ["k1_below_ceiling", "wide_past_ceiling",
                                   "banded_then_wide_past_ceiling"])
def test_agent_fallback_past_the_column_ceiling_is_the_half_grid_pass(
        rng, monkeypatch, route):
    """The card's routing of ``relative_features`` (the CPU route standing
    in: ``_on_card`` patched, the wrappers take their plain versions):
    below ``DENSE_COLUMN_CEILING`` lane-padded agents the agent pass's
    dense path is K1; past it (the ceiling patched down to 1,024 for a
    1,500-agent frame) it is the half-grid K2 pass and K1 is never called,
    also as the fallback of an inexact fine-grid pass.  The features equal
    the K1 route's wherever the half-grid pass is exact."""
    from piml_tpu_torch.physics import NeighborConfig, features

    pos, h = _wide_scene(rng, "cluster" if "banded" in route else "uniform")
    vel = torch.from_numpy(h)
    obstacles = _t(rng.rand(64, 2) * 100.0)     # under the 2^21 gate
    monkeypatch.setattr(features, "_on_card", lambda x: True)
    k1_calls = []
    real_k1 = pairwise.topk_neighbors_pallas

    def counting_k1(*args, **kw):
        k1_calls.append(args[0].shape)
        return real_k1(*args, **kw)

    monkeypatch.setattr(pairwise, "topk_neighbors_pallas", counting_k1)

    def feats(cfg):
        return features.relative_features(
            _t(pos), vel, torch.zeros_like(vel), _t(pos[::-1].copy()),
            obstacles, cfg)

    ref = feats(NeighborConfig(use_grid_topk=False))   # the K1 route
    assert len(k1_calls) == 1
    if route == "k1_below_ceiling":
        return
    k1_calls.clear()
    monkeypatch.setattr(features, "DENSE_COLUMN_CEILING", 1024)
    before = (banded.KERNEL.fallbacks, banded.KERNEL.wide_calls,
              banded.KERNEL.wide_relaxed)
    got = feats(NeighborConfig(use_grid_topk="banded" in route))
    assert k1_calls == []
    assert (banded.KERNEL.fallbacks, banded.KERNEL.wide_calls,
            banded.KERNEL.wide_relaxed) == (
        before[0] + ("banded" in route), before[1] + 1, before[2])
    for a, b in zip(got, ref):
        assert torch.equal(a, b)

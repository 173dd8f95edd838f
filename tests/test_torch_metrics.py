"""The port's OT and MMD against the JAX package (CPU): the masked
Sinkhorn (dense, streaming, banded with its exactness proof and its dense
fallback), the multi-kernel MMD (dense and streaming) and the per-frame
drivers.  Every input comes from a numpy seed.

Tolerances are the JAX package's own (tests/test_metrics.py,
tests/test_ot_banded.py): OT to rel 1e-4 / abs 1e-5, MMD to rel 1e-4 /
abs 1e-6.  The two packages take their logsumexps and sums in other
orders, so values agree to float32 rounding, not bit for bit; the banded
``exact`` flag must be equal.
"""

import jax
import numpy as np
import pytest
import torch

import _torch_compare  # noqa: F401  (shares the cores between workers)
from piml_tpu.metrics import metrics as jm
from piml_tpu.metrics import ot_banded as jb
from piml_tpu_torch.metrics import metrics as tm
from piml_tpu_torch.metrics import ot_banded as tb

OT_TOL = dict(rel=1e-4, abs=1e-5)
MMD_TOL = dict(rel=1e-4, abs=1e-6)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _clouds(rng, n, m, shift=0.5):
    x = rng.randn(n, 2).astype(np.float32)
    y = rng.randn(m, 2).astype(np.float32) + shift
    mx = (rng.rand(n) > 0.2).astype(np.float32)
    my = (rng.rand(m) > 0.2).astype(np.float32)
    return x, y, mx, my


# ---------------------------------------------------------------------------
# dense and streaming kernels, one frame
# ---------------------------------------------------------------------------

def test_sinkhorn_masked_matches_jax(rng):
    x, y, mx, my = _clouds(rng, 37, 53)
    ref = float(jm.sinkhorn_masked(x, y, mx, my))
    got = float(tm.sinkhorn_masked(*_t(x, y, mx, my)))
    assert got == pytest.approx(ref, **OT_TOL)


def test_sinkhorn_chunked_matches_jax(rng):
    """Block 16 at n = 37 / m = 53: neither a multiple of the block."""
    x, y, mx, my = _clouds(rng, 37, 53)
    ref = float(jm.sinkhorn_masked_chunked(x, y, mx, my, block=16))
    got = float(tm.sinkhorn_masked_chunked(*_t(x, y, mx, my), block=16))
    dense = float(tm.sinkhorn_masked(*_t(x, y, mx, my)))
    assert got == pytest.approx(ref, **OT_TOL)
    assert got == pytest.approx(dense, **OT_TOL)


def test_mmd_masked_matches_jax(rng):
    s, t, ms, mt = _clouds(rng, 41, 29, shift=0.3)
    ref = float(jm.mmd_masked(s, t, ms, mt))
    got = float(tm.mmd_masked(*_t(s, t, ms, mt)))
    assert got == pytest.approx(ref, **MMD_TOL)


def test_mmd_chunked_matches_jax(rng):
    s, t, ms, mt = _clouds(rng, 41, 29, shift=0.3)
    ref = float(jm.mmd_masked_chunked(s, t, ms, mt, block=16))
    got = float(tm.mmd_masked_chunked(*_t(s, t, ms, mt), block=16))
    dense = float(tm.mmd_masked(*_t(s, t, ms, mt)))
    assert got == pytest.approx(ref, **MMD_TOL)
    assert got == pytest.approx(dense, **MMD_TOL)


# ---------------------------------------------------------------------------
# per-frame drivers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dense_limit,mode", [(2048, "sum"), (8, "mean")])
def test_ot_with_time_mask_matches_jax(rng, dense_limit, mode):
    """Below the limit the frames run batched; ``dense_limit=8`` sends
    24-agent frames down the banded path with its dense fallback."""
    T, N = 3, 24
    p = rng.randn(T, N, 2).astype(np.float32)
    q = rng.randn(T, N, 2).astype(np.float32)
    mask = (rng.rand(T, N) > 0.2).astype(np.float32)
    mask[1, 1:] = 0.0                       # one frame with a single agent
    ref = float(jm.ot_with_time_mask(p, q, mask, mode,
                                     dense_limit=dense_limit))
    got = float(tm.ot_with_time_mask(*_t(p, q, mask), mode,
                                     dense_limit=dense_limit))
    assert got == pytest.approx(ref, **OT_TOL)


@pytest.mark.parametrize("dense_limit", [2048, 8])
def test_mmd_with_time_mask_matches_jax(rng, dense_limit):
    """Leading channel axes fold into the frame axis."""
    c, T, N = 2, 3, 24
    p = rng.randn(c, T, N, 2).astype(np.float32)
    q = rng.randn(c, T, N, 2).astype(np.float32)
    mask = (rng.rand(c, T, N) > 0.2).astype(np.float32)
    ref = float(jm.mmd_with_time_mask(p, q, mask, "mean",
                                      dense_limit=dense_limit))
    got = float(tm.mmd_with_time_mask(*_t(p, q, mask), "mean",
                                      dense_limit=dense_limit))
    assert got == pytest.approx(ref, **MMD_TOL)
    same = float(tm.mmd_with_time_mask(*_t(p, p, mask), "mean",
                                       dense_limit=dense_limit))
    assert same == pytest.approx(0.0, abs=1e-5)


def _iterations(x, y, mx, my):
    """The iteration at which one frame stops: the least ``max_iter`` that
    gives the uncapped value (a capped run equals it from there on)."""
    full = float(tm.sinkhorn_masked(x, y, mx, my))
    lo, hi = 1, 100
    while lo < hi:
        k = (lo + hi) // 2
        if float(tm.sinkhorn_masked(x, y, mx, my, max_iter=k)) == full:
            hi = k
        else:
            lo = k + 1
    return lo


def test_frames_stop_at_their_own_iteration_like_jax_vmap(rng):
    """Frames of one batch converge at different iterations; each keeps
    the potentials of its own stopping iteration, as under JAX's vmapped
    ``while_loop``.  Running every frame to ``max_iter`` is another
    result."""
    T, N = 4, 20
    scale = np.array([0.05, 0.5, 2.0, 6.0], np.float32)[:, None, None]
    p = (rng.randn(T, N, 2) * scale).astype(np.float32)
    q = (p + rng.randn(T, N, 2) * scale).astype(np.float32)
    mask = np.ones((T, N), np.float32)
    tp, tq, tmask = _t(p, q, mask)
    its = [_iterations(tp[t], tq[t], tmask[t], tmask[t]) for t in range(T)]
    assert len(set(its)) > 1, its
    ref = np.asarray(jax.vmap(jm.sinkhorn_masked)(p, q, mask, mask))
    got = tm.sinkhorn_masked(tp, tq, tmask, tmask).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    singles = [float(tm.sinkhorn_masked(tp[t], tq[t], tmask[t], tmask[t]))
               for t in range(T)]
    np.testing.assert_allclose(got, singles, rtol=1e-6)
    uncapped = tm.sinkhorn_masked(tp, tq, tmask, tmask, thresh=-1.0).numpy()
    assert not np.allclose(uncapped, got, rtol=1e-4, atol=0)


def test_padding_is_inert(rng):
    """Padded points (zero mask, non-finite or far positions) change
    neither OT nor MMD, dense or streaming."""
    x, y, mx, my = _clouds(rng, 30, 30)
    pad = np.full((10, 2), np.nan, np.float32)
    pad[::2] = 1e3
    xp, yp = np.concatenate([x, pad]), np.concatenate([y, pad])
    mxp = np.concatenate([mx, np.zeros(10, np.float32)])
    myp = np.concatenate([my, np.zeros(10, np.float32)])
    base, padded = _t(x, y, mx, my), _t(xp, yp, mxp, myp)
    for fn, tol in ((tm.sinkhorn_masked, OT_TOL),
                    (tm.mmd_masked, MMD_TOL)):
        assert float(fn(*padded)) == pytest.approx(float(fn(*base)), **tol)
    assert float(tm.sinkhorn_masked_chunked(*padded, block=16)) == \
        pytest.approx(float(tm.sinkhorn_masked(*base)), **OT_TOL)
    assert float(tm.mmd_masked_chunked(*padded, block=16)) == \
        pytest.approx(float(tm.mmd_masked(*base)), **MMD_TOL)


# ---------------------------------------------------------------------------
# banded Sinkhorn (n = 1200 crowds of tests/test_ot_banded.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def crowds():
    rng = np.random.default_rng(7)
    n = 1200
    p = rng.uniform(0, 126, (n, 2)).astype(np.float32)
    q = (p + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    masked = (np.random.default_rng(3).random(n) > 0.2).astype(np.float32)
    cp, cq = p.copy(), q.copy()
    h = n // 2
    cp[:h] = p[:h] * 0.02
    cq[:h] = cp[:h] + q[:h] * 1e-3
    full = np.ones(n, np.float32)
    return {"full": (p, q, full), "masked": (p, q, masked),
            "clustered": (cp, cq, full)}


@pytest.mark.parametrize("case", ["full", "masked", "clustered"])
def test_sinkhorn_banded_matches_jax(crowds, case):
    p, q, m = crowds[case]
    assert tb.ot_banded_params(len(p), len(q)) == \
        jb.ot_banded_params(len(p), len(q))
    ref_cost, ref_exact = jb.sinkhorn_banded(p, q, m, m)
    cost, exact = tb.sinkhorn_banded(*_t(p, q, m, m))
    assert bool(exact) == bool(ref_exact)
    if case != "clustered":
        assert bool(exact)
    if bool(exact):
        assert float(cost) == pytest.approx(float(ref_cost), **OT_TOL)
    if case == "full":
        dense = float(tm.sinkhorn_masked_chunked(*_t(p, q, m, m)))
        assert float(cost) == pytest.approx(dense, **OT_TOL)


def test_far_cloud_falls_back_to_the_streaming_value(crowds):
    """q 300 m away from p: no window holds a row's mass, the proof fails
    in both packages, and the fallback returns the streaming kernel's
    value bit for bit (the streaming kernel is held to JAX's above)."""
    p, _, m = (a[:300] for a in crowds["full"])
    q = (np.random.default_rng(11).uniform(0, 200, p.shape) + 300.0
         ).astype(np.float32)
    _, ref_exact = jb.sinkhorn_banded(p, q, m, m)
    _, exact = tb.sinkhorn_banded(*_t(p, q, m, m))
    assert not bool(exact) and not bool(ref_exact)
    got = tb.sinkhorn_banded_or_dense(*_t(p, q, m, m), block=128)
    stream = tm.sinkhorn_masked_chunked(*_t(p, q, m, m), block=128)
    assert torch.equal(got, stream)

"""Comparison helpers for the port's tests (tests/test_torch_*.py).

On the CPU the JAX package selects neighbours with matmul-expansion
distances, whose cancellation error (~1e-4 m at |p| ~ 50 m) is larger than
the gaps between some neighbours.  Two legitimate differences follow, and
:func:`assert_features_match` accepts exactly those, naming every row where
they occur instead of loosening the tolerance:

- a near-tie: two slots swap places because their distances differ by less
  than ``tie_tol``;
- a boundary flip: a neighbour whose distance is within ``tie_tol`` of the
  distance threshold, or of the other side's k-th neighbour, is kept on one
  side and left out on the other.
"""

import os

import numpy as np
import torch


def _share_cores() -> None:
    """Under pytest-xdist every worker process runs torch at once; an
    intra-op pool as wide as the machine in each of them oversubscribes
    the cores, and OpenMP's spin-waits then stall every worker.  Each
    worker takes its share of the cores instead."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))


_share_cores()


def assert_features_match(ref, got, dist_threshold, atol=1e-5, tie_tol=1e-3,
                          name="features", max_named=20):
    """``ref`` / ``got``: (..., k, 6) neighbour features.  Rows that differ
    beyond ``atol`` must be explained by a near-tie or a threshold flip.
    Returns the named rows."""
    ref = np.asarray(ref)
    got = np.asarray(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    k = ref.shape[-2]
    r2 = ref.reshape(-1, k, ref.shape[-1])
    g2 = got.reshape(-1, k, got.shape[-1])
    bad = np.nonzero(np.abs(r2 - g2).max(axis=(1, 2)) > atol)[0]
    named = []
    for row in bad:
        where = tuple(int(i) for i in np.unravel_index(row, ref.shape[:-2]))
        a, b = r2[row], g2[row]
        da = np.linalg.norm(a[:, :2], axis=-1)
        db = np.linalg.norm(b[:, :2], axis=-1)
        # every slot on one side has a twin on the other, unless it sits at
        # the threshold or at the other side's k-th neighbour
        for x, dx, y, dy in ((a, da, b, db), (b, db, a, da)):
            for s in range(k):
                if np.abs(y - x[s]).max(axis=-1).min() <= atol:
                    continue
                at_edge = (abs(dx[s] - dist_threshold) <= tie_tol
                           or abs(dx[s] - dy[-1]) <= tie_tol)
                empty = not x[s].any()
                assert at_edge or empty, (
                    f"{name} row {where}: slot {s} {x[s]} has no match and "
                    f"is not at a selection boundary")
        # slots present on both sides may only swap within near-ties
        live = (da > 0) & (db > 0)
        assert np.all(np.abs(da[live] - db[live]) <= tie_tol), (
            f"{name} row {where}: slot distances {da} vs {db}")
        named.append(where)
    assert len(named) <= max_named, f"{name}: {len(named)} rows differ"
    if named:
        print(f"{name}: near-tie / threshold rows {named}")
    return named

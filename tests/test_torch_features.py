"""piml_tpu_torch.physics.features against piml_tpu.physics.features on
the same seeded inputs (CPU).

Features are held to atol 1e-5 (float32 rounding of the same arithmetic);
rows where the JAX matmul-expansion distances reorder a near-tie or flip a
neighbour at the threshold are named by ``assert_features_match``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_compare import assert_features_match
from piml_tpu.physics import features as jf
from piml_tpu_torch.ops import contacts
from piml_tpu_torch.physics import features as tf


def _t(x):
    return torch.from_numpy(np.array(x))


def _frame(rng, n, m, extent, absent=0.1):
    pos = (rng.rand(n, 2) * extent).astype(np.float32)
    pos[rng.rand(n) < absent] = np.nan
    vel = rng.randn(n, 2).astype(np.float32)
    vel[rng.rand(n) < 0.05] = 0.0
    acc = (0.1 * rng.randn(n, 2)).astype(np.float32)
    dest = (rng.rand(n, 2) * extent).astype(np.float32)
    obs = (rng.rand(m, 2) * extent).astype(np.float32)
    return pos, vel, acc, dest, obs


def _compare(args, cfg_kw, tie_name):
    jcfg = jf.NeighborConfig(**cfg_kw)
    tcfg = tf.NeighborConfig(**cfg_kw)
    ref = jf.relative_features(*(jnp.asarray(a) for a in args), jcfg)
    got = tf.relative_features(*(_t(a) for a in args), tcfg)
    assert_features_match(ref[0], got[0].numpy(), tcfg.dist_threshold_ped,
                          name=tie_name + "/ped")
    assert_features_match(ref[1], got[1].numpy(), tcfg.dist_threshold_obs,
                          name=tie_name + "/obs")
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), atol=1e-5)


def test_relative_features_dense_route_matches_jax(rng):
    """N = 64: below the 2^21 gate, both packages take the matmul path."""
    _compare(_frame(rng, 64, 150, 20.0), {}, "dense")


def test_relative_features_banded_route_matches_jax(rng, monkeypatch):
    """N = 1,500, M = 1,400 with use_pallas_topk=False: both agent and
    obstacle pair grids cross 2^21, so both packages take the banded path
    (the port's plain K2) with the matmul pass as its fallback."""
    calls = []
    real = tf.banded.topk_neighbors_banded

    def spy(*args, **kw):
        calls.append(kw.get("same_objects", True))
        return real(*args, **kw)

    monkeypatch.setattr(tf.banded, "topk_neighbors_banded", spy)
    before = tf.banded.KERNEL.fallbacks
    _compare(_frame(rng, 1500, 1400, 70.0),
             dict(use_pallas_topk=False), "banded")
    assert calls == [True, False]          # agent pass, obstacle pass
    # a well-spread frame is provably exact: no pass fell back
    assert tf.banded.KERNEL.fallbacks == before


def test_relative_features_time_major_matches_jax(rng):
    """Rank-3 (t, N, 2) input with the full-trajectory heading fill."""
    t, n, m = 5, 40, 90
    pos = (rng.rand(t, n, 2) * 15).astype(np.float32)
    pos[:, rng.rand(n) < 0.2] = np.nan
    vel = rng.randn(t, n, 2).astype(np.float32)
    vel[1:3, :5] = 0.0
    acc = (0.1 * rng.randn(t, n, 2)).astype(np.float32)
    dest = (rng.rand(t, n, 2) * 15).astype(np.float32)
    obs = (rng.rand(m, 2) * 15).astype(np.float32)
    _compare((pos, vel, acc, dest, obs), {}, "time-major")


def test_heading_fill_matches_jax(rng):
    vel = rng.randn(30, 12, 2).astype(np.float32)
    vel[rng.rand(30, 12) < 0.4] = 0.0
    vel[:, 3] = 0.0                     # never moves
    ref = jf.heading_direction(jnp.asarray(vel))
    got = tf.heading_direction(_t(vel))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_heading_fill_rank4_matches_jax(rng):
    """A (C, T, N, 2) input: the zero-velocity fill runs along time for each
    channel (the JAX function vmaps it over channels), not along C."""
    vel = rng.randn(2, 5, 4, 2).astype(np.float32)
    vel[rng.rand(2, 5, 4) < 0.4] = 0.0
    vel[0, :, 1] = 0.0                  # never moves in channel 0
    vel[1, 1:4, 2] = 0.0                # a gap inside channel 1
    ref = jf.heading_direction(jnp.asarray(vel))
    got = tf.heading_direction(_t(vel))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    for c in range(2):                  # each channel as its own trajectory
        np.testing.assert_array_equal(
            got[c].numpy(), tf.heading_direction(_t(vel[c])).numpy())


def test_collision_helpers_match_jax(rng):
    pos = (rng.rand(20, 30, 2) * 5).astype(np.float32)
    pos[rng.rand(20, 30) < 0.2] = np.nan
    for thr in (0.5, 0.25):
        np.testing.assert_array_equal(
            tf.collision_detection(_t(pos), thr).numpy(),
            np.asarray(jf.collision_detection(jnp.asarray(pos), thr)))
        np.testing.assert_array_equal(
            tf.collision_detection_single_frame(_t(pos[0]), thr).numpy(),
            np.asarray(jf.collision_detection_single_frame(
                jnp.asarray(pos[0]), thr)))
    feats = rng.randn(50, 6, 6).astype(np.float32)
    np.testing.assert_array_equal(
        tf.collision_label(_t(feats)).numpy(),
        np.asarray(jf.collision_label(jnp.asarray(feats))))


@pytest.mark.parametrize("name", ["desired_speed", "history_velocity",
                                  "turn_detection", "move_index_matrix"])
def test_scene_helpers_match_jax(rng, name):
    T, N = 40, 25
    vel = rng.randn(T, N, 2).astype(np.float32)
    vel[:7, :4] = 0.0
    pos = np.cumsum(vel, axis=0).astype(np.float32) * 0.08
    pos[:5, 5:9] = np.nan
    mask = (rng.rand(T, N) < 0.8).astype(np.float32)
    if name == "desired_speed":
        ref = jf.desired_speed(jnp.asarray(vel), 25)
        got = tf.desired_speed(_t(vel), 25)
    elif name == "history_velocity":
        ref = jf.history_velocity(jnp.asarray(vel), 3)
        got = tf.history_velocity(_t(vel), 3)
    elif name == "turn_detection":
        ref = jf.turn_detection(jnp.asarray(pos), jnp.asarray(vel),
                                jnp.asarray(mask))
        got = tf.turn_detection(_t(pos), _t(vel), _t(mask))
    else:
        ref = jf.move_index_matrix(
            jf.move_index_matrix(jnp.asarray(mask), "backward", 24),
            "forward", 1)
        got = tf.move_index_matrix(
            tf.move_index_matrix(_t(mask), "backward", 24), "forward", 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_gather_filtered_matches_jax(rng):
    feats = rng.randn(3, 20, 30, 6).astype(np.float32)
    feats[0, 1, 2] = np.inf
    dist = (rng.rand(3, 20, 5) * 8).astype(np.float32)
    dist[1, 3] = np.inf
    idx = rng.randint(0, 30, size=(3, 20, 5))
    idx[0, 1, 0] = 2
    dist[0, 1, 0] = 1.0
    ref = jf.gather_filtered(jnp.asarray(feats), jnp.asarray(idx),
                             jnp.asarray(dist), 4.0)
    got = tf.gather_filtered(_t(feats), _t(idx), _t(dist), 4.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_contact_counts_in_row_chunks_match_jax(rng, monkeypatch):
    """The per-frame contact counts of a (C, T, N) batch, taken a few query
    rows at a time, equal the JAX package's all-pairs counts."""
    pos = (rng.rand(2, 3, 40, 2) * 4).astype(np.float32)
    pos[rng.rand(2, 3, 40) < 0.2] = np.nan
    monkeypatch.setattr(contacts, "_PAIR_CHUNK", 2 * 3 * 40 * 7)   # 7 rows
    for thr in (0.5, 0.25):
        np.testing.assert_array_equal(
            tf.collision_detection_single_frame(_t(pos), thr).numpy(),
            np.asarray(jf.collision_detection_single_frame(jnp.asarray(pos),
                                                           thr)))


@pytest.mark.parametrize("shape", [(30, 2), (2, 3, 40, 2), (4, 1, 2)])
def test_two_threshold_contact_counts_match_two_jax_calls(rng, shape):
    """One call with both thresholds returns what two single-threshold
    calls of the JAX package return, NaN rows, coincident agents and N = 1
    included, and on the CPU it never launches the kernel."""
    pos = (rng.rand(*shape) * 3).astype(np.float32)
    pos[rng.rand(*shape[:-1]) < 0.2] = np.nan
    if shape[-2] > 2:
        pos[..., 1, :] = pos[..., 2, :]       # coincident distinct agents
    launches = contacts.KERNEL.launches
    soft, hard = tf.collision_detection_single_frame(_t(pos), (0.5, 0.25))
    assert contacts.KERNEL.launches == launches
    for got, thr in ((soft, 0.5), (hard, 0.25)):
        np.testing.assert_array_equal(
            got.numpy(),
            np.asarray(jf.collision_detection_single_frame(jnp.asarray(pos),
                                                           thr)))


def test_obstacle_pass_sized_from_lane_padded_table_like_jax():
    """M = 300 obstacles (lane-padded to 384): the banded obstacle pass
    bins the grid and sizes the windows from the padded count, as the JAX
    package does, so both packages prove exactness over the same boxes."""
    from piml_tpu.ops import banded as jb

    n = 6000                 # n · 384 ≥ 2^21: the obstacle pass engages
    obs = (np.random.RandomState(1).rand(300, 2) * 100).astype(np.float32)
    cfg_kw = dict(use_pallas_topk=False)
    ref = jf.prepare_obstacle_index(n, jnp.asarray(obs),
                                    jf.NeighborConfig(**cfg_kw))
    got = tf.prepare_obstacle_index(n, _t(obs), tf.NeighborConfig(**cfg_kw))
    g_ref, w_ref = jb.banded_params(n, 384, 10, fine=True)
    assert tf._obstacle_params(n, 300, 10) == (g_ref, w_ref)
    assert got.offsets.shape == ref.offsets.shape == (g_ref * g_ref + 2,)
    assert got.cols.shape[-1] == ref.cols.shape[-1]
    # per-cell starts agree; the last entry also counts the JAX table's 84
    # NaN padding rows, which sit in the invalid bucket
    np.testing.assert_array_equal(got.offsets.numpy()[:-1],
                                  np.asarray(ref.offsets)[:-1])


def test_relative_features_batched_route_matches_jax(rng, monkeypatch):
    """C = 2 frames, N = 1,536, M = 2,000 with ``batched=True`` and
    use_pallas_topk=False: both packages take the channel-batched banded
    route for the agent and the obstacle pass (JAX: the vmapped
    interpret-mode kernel under one lax.cond)."""
    calls = []
    real = tf.banded.topk_neighbors_banded_batched

    def spy(*args, **kw):
        calls.append(kw.get("objects") is None)
        return real(*args, **kw)

    monkeypatch.setattr(tf.banded, "topk_neighbors_banded_batched", spy)
    frames = [_frame(rng, 1536, 2000, 60.0, absent=0.05) for _ in range(2)]
    pos, vel, acc, dest = (np.stack([f[i] for f in frames])
                           for i in range(4))
    obs = frames[0][4]
    head = np.asarray(jf.heading_direction(jnp.asarray(vel),
                                           time_axis=False))
    cfg_kw = dict(use_pallas_topk=False)
    ref = jf.relative_features(
        *(jnp.asarray(a) for a in (pos, vel, acc, dest, obs)),
        jf.NeighborConfig(**cfg_kw), heading=jnp.asarray(head), batched=True)
    before = tf.banded.KERNEL.fallbacks
    got = tf.relative_features(*(_t(a) for a in (pos, vel, acc, dest, obs)),
                               tf.NeighborConfig(**cfg_kw), heading=_t(head),
                               batched=True)
    assert calls == [True, False]          # agent pass, obstacle pass
    assert tf.banded.KERNEL.fallbacks == before
    assert got[0].shape == (2, 1536, 6, 6) and got[1].shape == (2, 1536, 10, 6)
    assert_features_match(ref[0], got[0].numpy(), 4.0, name="batched/ped")
    assert_features_match(ref[1], got[1].numpy(), 4.0, name="batched/obs")
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), atol=1e-5)


def _flag_routes(n, m, shape0, rank, batched, on_card, cfg):
    """The selection routes as the three flags, ``big_obs`` and the two
    fallback closures of ``relative_features`` chose them before the route
    table: each pass's selectors in call order."""
    lane = lambda x: max(128, -(-x // 128) * 128)   # noqa: E731
    gate = 2 ** 21
    big_single_frame = rank == 2 and n * lane(n) >= gate
    use_kernel = cfg.use_pallas_topk and big_single_frame and on_card
    card = on_card or not cfg.use_pallas_topk
    use_banded = cfg.use_grid_topk and big_single_frame and card
    use_banded_batched = (batched and cfg.use_grid_topk and rank == 3
                          and n * lane(n) >= gate and card)
    big_obs = shape0 * lane(m) >= gate
    ped_dense = ["dense"]
    if use_kernel:
        ped_dense = (["half_grid"] if lane(n) > tf.DENSE_COLUMN_CEILING
                     else ["k1"])
    obs_dense = ["k1"] if use_kernel and big_obs else ["dense"]
    ped = (["k2"] + ped_dense if use_banded or use_banded_batched
           else ped_dense)
    obs = (["k2"] + obs_dense
           if (use_banded and big_obs)
           or (use_banded_batched and n * lane(m) >= gate)
           else obs_dense)
    return ped, obs


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("m", [64, 4096])
@pytest.mark.parametrize("n", [337, 1408, 1409, 1448, 1449, 12685])
def test_selection_route_table_pins_the_flag_predicates(monkeypatch, n, m,
                                                        batched):
    """``selection_routes`` against the flags it replaced, with
    ``_on_card``, ``use_grid_topk`` and ``use_pallas_topk`` each either
    way: ``relative_features`` calls the routes the table names, the K2
    routes' fallbacks included (the spies run them), and
    ``prepare_obstacle_index`` builds an index exactly when the obstacle
    pass calls K2.  The engine's N² gate and the feature pass's
    lane-padded one disagree only at 1,409-1,448 agents."""
    calls = []

    def fake(position, k, objects):
        k = min(k, objects.shape[-2])
        return (torch.full(position.shape[:-1] + (k,), float("inf")),
                torch.zeros(position.shape[:-1] + (k,), dtype=torch.int64))

    def k2(position, heading, k, angle, dense_fn, objects=None, **kw):
        calls.append(("k2", objects is not None))
        assert (position.ndim == 3) == batched
        return dense_fn()

    def k1(position, heading, k, angle, objects=None, same_objects=True):
        calls.append(("k1", objects is not None))
        return fake(position, k, position if objects is None else objects)

    def half_grid(position, heading, k, *args):
        calls.append(("half_grid", False))
        return fake(position, k, position)

    def dense(position, objects, heading, k, angle, same_objects=False):
        calls.append(("dense", not same_objects))
        return fake(position, k, objects)

    monkeypatch.setattr(tf.banded, "topk_neighbors_banded_or_dense", k2)
    monkeypatch.setattr(tf.pairwise, "topk_neighbors_pallas", k1)
    monkeypatch.setattr(tf, "_banded_wide_fallback", half_grid)
    monkeypatch.setattr(tf, "nearby_in_sight", dense)
    g = torch.Generator().manual_seed(n)
    lead = (2,) if batched else ()
    pos = torch.rand(lead + (n, 2), generator=g) * 200.0
    vel = torch.randn(lead + (n, 2), generator=g)
    obs = torch.rand((m, 2), generator=g) * 200.0
    for on_card in (False, True):
        monkeypatch.setattr(tf, "_on_card", lambda x: on_card)
        for grid in (False, True):
            for pallas in (False, True):
                cfg = tf.NeighborConfig(use_grid_topk=grid,
                                        use_pallas_topk=pallas)
                case = (on_card, grid, pallas)
                calls.clear()
                index = tf.prepare_obstacle_index(n, obs, cfg)
                tf.relative_features(pos, vel, torch.zeros_like(vel), pos,
                                     obs, cfg, heading=vel,
                                     obstacle_index=index, batched=batched)
                ped = [c for c, is_obs in calls if not is_obs]
                obs_calls = [c for c, is_obs in calls if is_obs]
                assert (ped, obs_calls) == _flag_routes(
                    n, m, pos.shape[0], pos.ndim, batched, on_card, cfg), case
                assert (index is not None) == ("k2" in obs_calls), case
                feature = tf.selection_routes(n, m, 3, True, True, cfg)[0]
                split = (tf.engine_uses_grid(n, cfg)
                         != (feature[0] == tf.BANDED_BATCHED))
                assert split == (grid and 1409 <= n <= 1448), case


@pytest.mark.parametrize("route", ["dense", "banded"])
def test_relative_features_gradient_matches_jax(rng, route):
    """Gradients of a weighted sum of the features with respect to the
    positions and velocities, against ``jax.grad``: selection carries none
    (stop_gradient / comparisons on both sides), the gathered states do."""
    import jax

    n, m, extent = (64, 150, 20.0) if route == "dense" else (1500, 1400, 70.0)
    pos, vel, acc, dest, obs = _frame(rng, n, m, extent, absent=0.05)
    head = np.asarray(jf.heading_direction(jnp.asarray(vel),
                                           time_axis=False))
    w = [rng.randn(n, 6, 6).astype(np.float32),
         rng.randn(n, 10, 6).astype(np.float32),
         rng.randn(n, 2).astype(np.float32)]
    cfg_kw = {} if route == "dense" else dict(use_pallas_topk=False)

    def jloss(p, v):
        out = jf.relative_features(p, v, jnp.asarray(acc), jnp.asarray(dest),
                                   jnp.asarray(obs), jf.NeighborConfig(**cfg_kw),
                                   heading=jnp.asarray(head))
        return sum(jnp.sum(o * jnp.asarray(wi)) for o, wi in zip(out, w))

    ref = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(pos), jnp.asarray(vel))
    p, v = _t(pos).requires_grad_(True), _t(vel).requires_grad_(True)
    out = tf.relative_features(p, v, _t(acc), _t(dest), _t(obs),
                               tf.NeighborConfig(**cfg_kw), heading=_t(head))
    sum((o * _t(wi)).sum() for o, wi in zip(out, w)).backward()
    for got, r in ((p.grad, ref[0]), (v.grad, ref[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), atol=1e-4)

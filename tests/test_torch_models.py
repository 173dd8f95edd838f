"""The port's model zoo against the JAX package's (CPU): ``pinnsf_bm`` on
the trained weights, and every registry name and finetune swap on a flax
tree initialised here, converted and loaded strictly.

Tolerances:
- float32 forward: rtol 1e-5 / atol 1e-5 on every output; both sides
  compute in float32 (TF32 is off in the port) but sum in different
  orders;
- ``compute_dtype="bfloat16"``: the port against the JAX package's own
  bfloat16 forward, jitted as the JAX package runs it, within
  ``0.02 · max(|pred_acc_f32|, 1)``.  Eager JAX rounds each op's result
  to bfloat16 as the port does; under ``jit`` XLA fuses ops and keeps
  some intermediates in float32, so the two round at other places.  On
  the test's inputs the gap is at most 0.0090 of the scale (the test
  prints it); 0.02 leaves about twice that, inside the JAX test's own
  bound for bfloat16 against float32, ``0.03 · max(|pred|, 1)``;
- ``apply_collision_rules``: rtol 1e-5 / atol 1e-5.
"""

import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from flax.serialization import msgpack_restore

from piml_tpu.config import PIMLConfig as JaxConfig
import jax

from piml_tpu.models import ModelSpec as JaxSpec, build_model as jax_build
from piml_tpu.models import build_finetune_model as jax_build_finetune
from piml_tpu.models.zoo import apply_collision_rules as jax_collision_rules
from piml_tpu_torch.config import PIMLConfig
from piml_tpu_torch.models import (ModelSpec, apply_collision_rules,
                                   build_finetune_model, build_model,
                                   goal_acceleration, load_fixture)
from piml_tpu_torch.models.convert import (FIXTURE, PRETRAINED, flatten_tree,
                                           params_from_flax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MSGPACK = os.path.join(REPO, "bench_fixtures", "pinnsf_bm_gc_finetuned.msgpack")
PRE_MSGPACK = os.path.join(REPO, "bench_fixtures",
                           "pinnsf_bm_gc_pretrained.msgpack")
CFG = dict(model="pinnsf_bm", dataset_name="gc2344", dropout=0.0)


@pytest.fixture(scope="module")
def flax_params():
    with open(MSGPACK, "rb") as f:
        return msgpack_restore(f.read())


def test_fixture_npz_equals_msgpack(flax_params):
    """The committed npz is the msgpack's tree, array for array."""
    ref = flatten_tree(flax_params["params"])
    with np.load(FIXTURE) as z:
        got = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_converted_state_dict_loads_strictly(flax_params):
    model = build_model(ModelSpec.from_config(PIMLConfig(**CFG)))
    sd = params_from_flax(flax_params)
    model.load_state_dict(sd, strict=True)
    # a flax Dense kernel is (in, out); torch's Linear weight is (out, in)
    k = flax_params["params"]["ped_encoder"]["dense_0"]["kernel"]
    np.testing.assert_array_equal(
        model.ped_encoder.dense_0.weight.detach().numpy(), np.asarray(k).T)


@pytest.mark.parametrize("batch", [(37,), (3, 11)])
def test_pinnsf_bm_forward_matches_jax(flax_params, rng, batch):
    """Paper width: encoder 3×128, one ResBlock of 128, decoder 2×64."""
    pf = rng.randn(*batch, 6, 6).astype(np.float32)
    of = rng.randn(*batch, 10, 6).astype(np.float32)
    sf = rng.randn(*batch, 7).astype(np.float32)
    pf[..., 4:, :] = 0.0            # zero-padded neighbour slots
    sf[..., 0, :2] = 0.0            # zero destination vector

    jmodel = jax_build(JaxSpec.from_config(JaxConfig(**CFG)))
    ref = jmodel.apply(flax_params, jnp.asarray(pf), jnp.asarray(of),
                       jnp.asarray(sf))
    model = build_model(ModelSpec.from_config(PIMLConfig(**CFG)))
    model.load_state_dict(load_fixture())
    model.eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(pf), torch.from_numpy(of),
                    torch.from_numpy(sf))
    for field in ("pred_acc", "ped_msgs", "obs_msgs", "coll_pred"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(ref, field)),
                                   rtol=1e-5, atol=1e-5, err_msg=field)


def test_pretrained_fixture_npz_equals_msgpack():
    """The finetune's warm start: the committed pretrained npz is the
    pretrained msgpack's tree, array for array."""
    with open(PRE_MSGPACK, "rb") as f:
        ref = flatten_tree(msgpack_restore(f.read())["params"])
    with np.load(PRETRAINED) as z:
        got = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_pinnsf_bm_live_dropout_matches_jax_statistics(flax_params, rng):
    """Dropout on the processors' outputs: the JAX package and the port
    draw different masks, so the forward is compared in distribution —
    the mean of the predicted acceleration over many draws agrees with
    the JAX package's to within the draws' noise."""
    import jax

    cfg = dict(CFG, dropout=0.5)
    pf = rng.randn(1, 6, 6).astype(np.float32)
    of = rng.randn(1, 10, 6).astype(np.float32)
    sf = rng.randn(1, 7).astype(np.float32)
    draws = 400
    jmodel = jax_build(JaxSpec.from_config(JaxConfig(**cfg)))
    keys = jax.random.split(jax.random.PRNGKey(0), draws)
    ref = np.asarray(jax.jit(jax.vmap(lambda k: jmodel.apply(
        flax_params, jnp.asarray(pf), jnp.asarray(of), jnp.asarray(sf),
        deterministic=False, rngs={"dropout": k}).pred_acc))(keys))
    model = build_model(ModelSpec.from_config(PIMLConfig(**cfg)))
    model.load_state_dict(load_fixture())
    gen = [torch.Generator().manual_seed(0)]     # one per leading slice
    with torch.no_grad():
        got = np.stack([model(torch.from_numpy(pf), torch.from_numpy(of),
                              torch.from_numpy(sf), gen).pred_acc.numpy()
                        for _ in range(draws)])
        det = model(torch.from_numpy(pf), torch.from_numpy(of),
                    torch.from_numpy(sf)).pred_acc.numpy()
    noise = 4 * np.sqrt((ref.var(0) + got.var(0)) / draws)
    assert np.all(np.abs(got.mean(0) - ref.mean(0)) <= noise)
    assert np.all(got.std(0) > 0)
    # without a generator the forward is the deterministic one
    jdet = jmodel.apply(flax_params, jnp.asarray(pf), jnp.asarray(of),
                        jnp.asarray(sf))
    np.testing.assert_allclose(det, np.asarray(jdet.pred_acc), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the whole zoo, on flax trees initialised here
# ---------------------------------------------------------------------------

ZOO = ("base", "base1", "base2", "base3", "base4", "base5", "base6", "base7",
       "base_nd", "base_test", "pinnsf", "pinnsf2", "pinnsf_polar",
       "pinnsf_bottleneck", "pinnsf_pb", "pinnsf_pbc", "pinnsf_bm",
       "pinnsf_m", "pinnsf_res")
TINY = dict(encoder_hidden_size=16, processor_hidden_size=16,
            decoder_hidden_size=8, processor_hidden_layers=2,
            res_hidden_layers=2, dropout=0.0)
OUTPUTS = ("pred_acc", "ped_msgs", "obs_msgs", "coll_pred")


def _inputs(rng, batch=(37,)):
    """Seeded features with zero-padded neighbour slots and non-zero
    destinations (``dest_mode="unit"`` has no guard against a zero one)."""
    pf = rng.randn(*batch, 6, 6).astype(np.float32)
    of = rng.randn(*batch, 10, 6).astype(np.float32)
    sf = rng.randn(*batch, 7).astype(np.float32)
    pf[..., 4:, :] = 0.0
    sf[..., :2] += np.where(sf[..., :2] >= 0, 0.5, -0.5)
    return pf, of, sf


def _both(name, finetune=False, **spec_kw):
    """The JAX model with a fresh flax tree, and the port's model with
    that tree converted and loaded strictly."""
    spec_kw = dict(TINY, **spec_kw)
    jspec, spec = JaxSpec(name=name, **spec_kw), ModelSpec(name=name,
                                                           **spec_kw)
    jmodel = (jax_build_finetune if finetune else jax_build)(jspec)
    model = (build_finetune_model if finetune else build_model)(spec)
    pf, of, sf = _inputs(np.random.RandomState(0), (2,))
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(3), pf, of, sf))
    model.load_state_dict(params_from_flax(params), strict=True)
    return jax.jit(jmodel.apply), params, model.eval()


def _assert_outputs(got, ref, **tol):
    for field in OUTPUTS:
        g, r = getattr(got, field), getattr(ref, field)
        assert (g is None) == (r is None), field
        if r is not None:
            assert g.dtype == torch.float32, field
            np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                       err_msg=field, **tol)


def _forward(model, pf, of, sf):
    with torch.no_grad():
        return model(torch.from_numpy(pf), torch.from_numpy(of),
                     torch.from_numpy(sf))


ZOO_CASES = ([(n, False, False) for n in ZOO]
             + [("base", True, False), ("pinnsf_res", True, False),
                ("pinnsf_m", False, True), ("base", False, True)])


@pytest.mark.parametrize(
    "name,finetune,chain", ZOO_CASES,
    ids=[f"{n}{'-finetune' if f else ''}{'-chain' if c else ''}"
         for n, f, c in ZOO_CASES])
def test_zoo_forward_matches_jax(rng, name, finetune, chain):
    """Every registry name, the two finetune swaps and the fixed residual
    chain: a flax tree converts and loads with ``strict=True``, and all
    four outputs agree, None where the JAX model returns None."""
    jmodel, params, model = _both(name, finetune, resdnn_chain=chain)
    pf, of, sf = _inputs(rng)
    ref = jmodel(params, pf, of, sf)
    _assert_outputs(_forward(model, pf, of, sf), ref, rtol=1e-5, atol=1e-5)


def test_pinnsf_m_paper_width_forward_matches_jax(rng):
    """The default model at the paper's widths: encoder 3×128, one
    effective ResBlock of 128, decoder 2×64."""
    jmodel, params, model = _both("pinnsf_m", encoder_hidden_size=128,
                                  processor_hidden_size=128,
                                  decoder_hidden_size=64,
                                  processor_hidden_layers=16)
    pf, of, sf = _inputs(rng, (64,))
    ref = jmodel(params, pf, of, sf)
    got = _forward(model, pf, of, sf)
    assert got.ped_msgs.shape == (64, 6, 128)
    _assert_outputs(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["pinnsf_pb", "pinnsf_pbc", "pinnsf_m"])
def test_channel_batch_matches_jax_per_channel(rng, name):
    """The port runs the model on a (C, N, ...) channel batch where the
    JAX package vmaps it over the channels: the polar heading takes no
    temporal fill along C."""
    jmodel, params, model = _both(name)
    pf, of, sf = _inputs(rng, (3, 11))
    sf[1, :4, 2:4] = 0.0          # zero velocities: the fill would act
    ref = jax.vmap(lambda a, b, c: jmodel(params, a, b, c))(pf, of, sf)
    _assert_outputs(_forward(model, pf, of, sf), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["pinnsf_m", "pinnsf_bm", "base",
                                  "base_test"])
def test_bf16_forward_matches_jax_bf16(rng, name):
    """``compute_dtype="bfloat16"``: float32 outputs, float32
    parameters, the JAX package's bfloat16 forward within 0.02 of the
    output's scale, and the JAX test's bound of the float32 forward."""
    _, params, _ = _both(name)
    cfg = dict(TINY, model=name, compute_dtype="bfloat16")
    jspec = JaxSpec.from_config(JaxConfig(**cfg))
    spec = ModelSpec.from_config(PIMLConfig(**cfg))
    assert (spec.tau, jspec.compute_dtype) == (jspec.tau, "bfloat16")
    assert spec.nn_dtype == torch.bfloat16
    model = build_model(spec)
    model.load_state_dict(params_from_flax(params), strict=True)
    pf, of, sf = _inputs(rng, (32,))
    ref16 = jax.jit(jax_build(jspec).apply)(params, pf, of, sf)
    ref32 = jax.jit(jax_build(dataclasses.replace(
        jspec, compute_dtype=None)).apply)(params, pf, of, sf)
    got = _forward(model, pf, of, sf)
    scale = max(float(np.abs(np.asarray(ref32.pred_acc)).max()), 1.0)
    _assert_outputs(got, ref16, rtol=0, atol=0.02 * scale)
    share = np.abs(got.pred_acc.numpy()
                   - np.asarray(ref16.pred_acc)).max() / scale
    print(f"{name}: bf16 pred_acc {share:.4f} of the scale from JAX's")
    gap = np.abs(got.pred_acc.numpy() - np.asarray(ref32.pred_acc)).max()
    assert gap < 0.03 * scale, (gap, scale)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    if name == "base_test":
        # its second output is the goal force: float32, untouched
        assert torch.equal(got.ped_msgs, goal_acceleration(
            torch.from_numpy(sf), spec.tau, False))


def _collision_inputs(rng, case):
    """Rows whose nearest in-radius neighbour is head-on (approaching
    each other) or chased (ahead, moving the same way, slower), among
    random rows, rows with no neighbour in the radius and rows whose
    two flagged neighbours tie in distance."""
    n, k = 24, 4
    pf = np.zeros((n, k, 6), np.float32)
    sf = rng.randn(n, 7).astype(np.float32)
    vi = np.tile([[1.0, 0.0]], (n, 1)).astype(np.float32)
    sf[:, 2:4] = vi
    ahead = np.stack([rng.uniform(0.1, 0.6, n), rng.uniform(-0.1, 0.1, n)],
                     -1)
    vj = (np.array([-1.0, 0.0]) if case == "head_on"
          else np.array([0.4, 0.0]))
    pf[:, 0, :2] = ahead
    pf[:, 0, 2:4] = vj - vi                       # relative velocity
    pf[:, 1, :2] = ahead * 1.5                    # a farther one
    pf[:, 1, 2:4] = vj - vi
    pf[:, 2:, :] = rng.randn(n, k - 2, 6) * 2.0   # random others
    pf[:4, 1, :2] = pf[:4, 0, :2]                 # exact ties
    pf[4:6, :, :2] += 5.0                         # nothing in the radius
    pf[6, 3, :] = np.nan                          # an absent slot
    pred = rng.randn(n, 2).astype(np.float32)
    return pred, pf, sf


@pytest.mark.parametrize("case", ["head_on", "chasing"])
def test_apply_collision_rules_matches_jax(rng, case):
    pred, pf, sf = _collision_inputs(rng, case)
    ref = np.asarray(jax_collision_rules(jnp.asarray(pred), jnp.asarray(pf),
                                         jnp.asarray(sf), 0.5, 0.08))
    got = apply_collision_rules(torch.from_numpy(pred), torch.from_numpy(pf),
                                torch.from_numpy(sf), 0.5, 0.08).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # the branch under test fired on the crafted rows and not on the
    # rows with nothing in the radius
    changed = np.abs(got - pred).max(axis=-1) > 1e-6
    assert changed[6:].sum() >= 12 and not changed[4:6].any()


def test_converter_keeps_top_level_parameters():
    """``pinnsf2``'s scalar ``tau_delta`` is a 0-d leaf at the top of the
    flax tree; it converts to a parameter of the same name."""
    _, params, model = _both("pinnsf2")
    assert np.asarray(params["params"]["tau_delta"]).shape == ()
    assert model.tau_delta.shape == ()
    with pytest.raises(ValueError):
        params_from_flax({"ped_encoder": {"dense_0": {"scale": np.ones(2)}}})

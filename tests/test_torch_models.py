"""The port's ``pinnsf_bm`` against the JAX package's, on the trained
weights (CPU).

The forward agrees to rtol 1e-5 / atol 1e-5: both sides compute in float32
(TF32 is off in the port) but sum in different orders.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from flax.serialization import msgpack_restore

from piml_tpu.config import PIMLConfig as JaxConfig
from piml_tpu.models import ModelSpec as JaxSpec, build_model as jax_build
from piml_tpu_torch.config import PIMLConfig
from piml_tpu_torch.models import ModelSpec, build_model, load_fixture
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


def test_only_pinnsf_bm_is_ported():
    with pytest.raises(NotImplementedError):
        build_model(ModelSpec(name="pinnsf_m"))


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

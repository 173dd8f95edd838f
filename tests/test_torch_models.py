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
from piml_tpu_torch.models.convert import FIXTURE, flatten_tree, params_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MSGPACK = os.path.join(REPO, "bench_fixtures", "pinnsf_bm_gc_finetuned.msgpack")
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

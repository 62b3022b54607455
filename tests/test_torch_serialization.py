"""The port's canonical serialization against the reference's: identical
weights must give byte-identical ``serialize_pytree`` output (HCDS
commitments and block model digests hash these bytes), the same flat
vector, and exact unflatten round-trips. Exact comparisons throughout."""

import jax
import numpy as np
import pytest
import torch

from repro.core import serialization as jser
from repro.models.mlp import MLPConfig as JMLPConfig
from repro.models.mlp import mlp_init as jmlp_init
from repro_torch.core import serialization as tser
from repro_torch.fl.adapters import params_from_jax
from repro_torch.models.mlp import MLPConfig


def _ref_params(hidden=16, seed=0):
    p = jmlp_init(JMLPConfig(hidden=hidden), jax.random.key(seed))
    return {k: np.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("hidden", [16, 128])
def test_mlp_bytes_identical(hidden):
    ref = _ref_params(hidden)
    port = params_from_jax(ref, MLPConfig(hidden=hidden), device="cpu")
    assert tser.serialize_pytree(port) == jser.serialize_pytree(ref)


def test_flatten_order_and_values():
    ref = _ref_params()
    port = params_from_jax(ref, MLPConfig(hidden=16), device="cpu")
    assert [p for p, _ in tser._sorted_leaves(port)] == \
        ["['b1']", "['b2']", "['w1']", "['w2']"]
    np.testing.assert_array_equal(tser.flatten_pytree(port).numpy(),
                                  np.asarray(jser.flatten_pytree(ref)))


def test_unflatten_round_trip_and_reference_flat():
    ref = _ref_params()
    port = params_from_jax(ref, MLPConfig(hidden=16), device="cpu")
    flat = tser.flatten_pytree(port)
    back = tser.unflatten_pytree(flat, port)
    assert set(back) == set(port)
    for k in port:
        assert back[k].dtype == port[k].dtype
        assert torch.equal(back[k], port[k])
    # a reference flat vector (numpy) unflattens to the same tree
    from_ref = tser.unflatten_pytree(np.asarray(jser.flatten_pytree(ref)),
                                     port)
    assert all(torch.equal(from_ref[k], port[k]) for k in port)


def test_nested_and_bare_leaves_match_reference(rng):
    tree = {"b": {"z": rng.normal(size=(3,)).astype(np.float32),
                  "a": rng.normal(size=(2, 2)).astype(np.float32)},
            "a": np.arange(5, dtype=np.int32)}
    port = {"b": {k: torch.from_numpy(v) for k, v in tree["b"].items()},
            "a": torch.from_numpy(tree["a"])}
    assert tser.serialize_pytree(port) == jser.serialize_pytree(tree)
    bare = rng.normal(size=(7,)).astype(np.float32)
    assert tser.serialize_pytree(torch.from_numpy(bare)) == \
        jser.serialize_pytree(bare)
    np.testing.assert_array_equal(tser.flatten_pytree(port).numpy(),
                                  np.asarray(jser.flatten_pytree(tree)))


def test_unflatten_rejects_wrong_size():
    port = params_from_jax(_ref_params(), MLPConfig(hidden=16),
                           device="cpu")
    with pytest.raises(ValueError, match="elements"):
        tser.unflatten_pytree(torch.zeros(3), port)


@pytest.mark.parametrize("bad", ["name", "shape", "dtype"])
def test_params_from_jax_checks(bad):
    ref = _ref_params()
    if bad == "name":
        ref["w3"] = ref.pop("w2")
        err = ValueError
    elif bad == "shape":
        ref["w1"] = ref["w1"][:, :8]
        err = ValueError
    else:
        ref["b1"] = ref["b1"].astype(np.float64)
        err = TypeError
    with pytest.raises(err):
        params_from_jax(ref, MLPConfig(hidden=16), device="cpu")


def test_bf16_leaves_bytes_identical(rng):
    """A mixed float32/bfloat16 tree (RWKV-6 keeps embed and lm_head in
    bfloat16): the reference writes a bfloat16 leaf as dtype '<V2' and its
    raw 2-byte values; the port must write the same bytes."""
    import jax.numpy as jnp
    vals = {"embed": rng.normal(size=(5, 3)).astype(np.float32),
            "layers": {"w": rng.normal(size=(2, 3)).astype(np.float32)},
            "lm_head": rng.normal(size=(3,)).astype(np.float32)}
    ref = {"embed": np.asarray(jnp.asarray(vals["embed"], jnp.bfloat16)),
           "layers": {"w": vals["layers"]["w"]},
           "lm_head": np.asarray(jnp.asarray(vals["lm_head"], jnp.bfloat16))}
    port = {"embed": torch.from_numpy(vals["embed"]).to(torch.bfloat16),
            "layers": {"w": torch.from_numpy(vals["layers"]["w"])},
            "lm_head": torch.from_numpy(vals["lm_head"]).to(torch.bfloat16)}
    data = tser.serialize_pytree(port)
    assert data == jser.serialize_pytree(ref)
    assert b"<V2" in data
    flat = jser.deserialize_pytree_flat(data)
    assert flat["['embed']"].view(np.uint16).tolist() == \
        port["embed"].view(torch.int16).numpy().view(np.uint16).tolist()
    np.testing.assert_array_equal(tser.flatten_pytree(port).numpy(),
                                  np.asarray(jser.flatten_pytree(ref)))
    assert tser.serialize_pytree(port["embed"]) == \
        jser.serialize_pytree(ref["embed"])

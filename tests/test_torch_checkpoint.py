"""Checkpoints of the port (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``), on the CPU: checkpoint/resume of the
PoFEL train state (``tests/test_trainstate_checkpoint.py`` on the port),
the file format both ways (a checkpoint either package writes loads in
the other, digest verified; both write the same arrays, key paths, true
dtypes and digest for one tree), and ``core.recovery``'s snapshots with a
model beside the ledger. Exact: a checkpoint copies bits.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as j_load_checkpoint
from repro.checkpoint import save_checkpoint as j_save_checkpoint
from repro.configs import get_config as j_get_config
from repro.fl import pofel_trainer as jpt
from repro.models.model_api import Model as JModel
from repro.models.transformer import FwdOptions as JFwdOptions
from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.core.consensus import PoFELConsensus
from repro_torch.core.recovery import load_snapshot, save_snapshot
from repro_torch.core.serialization import leaves_with_paths
from repro_torch.fl import pofel_trainer as pt
from repro_torch.models.model_api import Model
from repro_torch.models.transformer import FwdOptions

OPTS = FwdOptions(remat=False)


def _batch(rng, C=2, B=2, S=16):
    return {"tokens": torch.from_numpy(
                rng.integers(0, 500, (C, B, S)).astype(np.int32)),
            "labels": torch.from_numpy(
                rng.integers(0, 500, (C, B, S)).astype(np.int32))}


def _assert_trees_equal(a, b):
    pa, pb = leaves_with_paths(a), leaves_with_paths(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (path, x), (_, y) in zip(pa, pb):
        assert x.dtype == y.dtype and torch.equal(x, y), path


@pytest.fixture(scope="module")
def reference_state():
    """A reference state after one round (StarCoder2-3B reduced, two
    clusters), as numpy."""
    jm = JModel(j_get_config("starcoder2-3b").reduced())
    cfg = jpt.PoFELTrainConfig(n_clusters=2, inner_lr=1e-2)
    state = jax.jit(lambda key: jpt.init_train_state(jm, cfg, key))(
        jax.random.key(0))
    rng = np.random.default_rng(0)
    batch = {k: jnp.asarray(v.numpy()) for k, v in _batch(rng).items()}
    state, _ = jax.jit(lambda s, b: jpt.pofel_round(
        jm, s, b, jnp.ones((2,)), cfg, JFwdOptions(remat=False)))(state,
                                                                   batch)
    return jax.tree.map(np.asarray, state)


def test_pofel_state_checkpoint_resume(tmp_path):
    model = Model(get_config("starcoder2-3b").reduced(), device="cpu")
    cfg = pt.PoFELTrainConfig(n_clusters=2, inner_lr=1e-2)
    state = pt.init_train_state(model, cfg, torch.Generator().manual_seed(0))
    batch = _batch(np.random.default_rng(0))
    lam = torch.ones((2,))

    state, _ = pt.pofel_round(model, state, batch, lam, cfg, OPTS)
    save_checkpoint(tmp_path, int(state.round), state)
    assert latest_step(tmp_path) == 1

    restored = load_checkpoint(tmp_path, 1, state)
    _assert_trees_equal(restored, state)
    # continuing from restored state gives bit-identical results
    s1, m1 = pt.pofel_round(model, state, batch, lam, cfg, OPTS)
    s2, m2 = pt.pofel_round(model, restored, batch, lam, cfg, OPTS)
    assert torch.equal(m1.similarities, m2.similarities)
    assert torch.equal(m1.loss, m2.loss)
    _assert_trees_equal(s1.global_params, s2.global_params)


def test_reference_checkpoint_loads_in_the_port(tmp_path, reference_state):
    """The reference writes, the port reads with its digest verified, bit
    for bit; a port checkpoint of the same state matches the reference's
    file: arrays, key paths, true dtypes, digest."""
    model = Model(get_config("starcoder2-3b").reduced(), device="cpu")
    port_state = pt.train_state_from_jax(reference_state, model)
    j_save_checkpoint(tmp_path / "ref", 1, reference_state)
    loaded = load_checkpoint(tmp_path / "ref", 1, port_state)
    _assert_trees_equal(loaded, port_state)

    save_checkpoint(tmp_path / "port", 1, port_state)
    ref_m = json.loads((tmp_path / "ref" / "step_1.json").read_text())
    port_m = json.loads((tmp_path / "port" / "step_1.json").read_text())
    assert port_m == ref_m
    assert any(v == "bfloat16" for v in port_m["true_dtypes"].values())
    assert port_m["keypaths"][0].startswith(".cluster_params[")
    assert port_m["keypaths"][-2:] == [".btsv_history", ".round"]
    with np.load(tmp_path / "ref" / "step_1.npz") as a, \
            np.load(tmp_path / "port" / "step_1.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype, name
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_port_checkpoint_loads_in_the_reference(tmp_path, reference_state):
    model = Model(get_config("starcoder2-3b").reduced(), device="cpu")
    port_state = pt.train_state_from_jax(reference_state, model)
    save_checkpoint(tmp_path, 3, port_state, metadata={"arch": "sc2"})
    tree = j_load_checkpoint(tmp_path, 3, reference_state)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(reference_state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_tampered_checkpoint_is_refused(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
    save_checkpoint(tmp_path, 0, tree)
    _assert_trees_equal(load_checkpoint(tmp_path, 0, tree), tree)
    manifest = tmp_path / "step_0.json"
    m = json.loads(manifest.read_text())
    m["digest"] = "00" * 32
    manifest.write_text(json.dumps(m))
    with pytest.raises(ValueError, match="integrity"):
        load_checkpoint(tmp_path, 0, tree)
    assert load_checkpoint(tmp_path, 0, tree, verify=False)["a"].shape == \
        (2, 3)
    assert latest_step(tmp_path / "none") is None


def _mini_chain(n_nodes=3, rounds=2):
    cons = PoFELConsensus(n_nodes=n_nodes)
    rng = np.random.default_rng(0)
    for _ in range(rounds):
        models = [{"w": torch.from_numpy(rng.normal(size=4).astype(
            np.float32))} for _ in range(n_nodes)]
        cons.run_round(models, data_sizes=[1.0] * n_nodes)
    return cons


def test_snapshot_directory_roundtrip(tmp_path):
    """save_snapshot with a model tree writes it beside the ledger at step
    = chain height, load_snapshot reads both back (the reference's
    tests/test_recovery.py test of the same name)."""
    cons = _mini_chain()
    led = cons.ledgers[1]
    model = {"w": np.arange(4, dtype=np.float32)}
    save_snapshot(tmp_path, led, model_tree=model)
    assert latest_step(tmp_path) == led.height
    restored, restored_model = load_snapshot(
        tmp_path, node_id=1, public_keys=cons.public_keys,
        model_template=model)
    assert restored.head_hash == led.head_hash
    np.testing.assert_array_equal(restored_model["w"].numpy(), model["w"])
    again, none = load_snapshot(tmp_path, node_id=1,
                                public_keys=cons.public_keys)
    assert again.head_hash == led.head_hash and none is None

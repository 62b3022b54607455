"""The PoFEL trainer's launcher in the port (``repro_torch.launch.train``)
against the reference's (``repro.launch.train``), on the CPU: the token
stream bit for bit, the host-side block of a round field for field, and
reduced training runs whose chains verify. Exact throughout: numpy
draws, JSON bodies and deterministic (RFC 6979) signatures.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.blockchain.ledger import Ledger as JLedger
from repro.core import crypto as jcrypto
from repro.data.tokens import TokenBatchSpec as JSpec
from repro.data.tokens import synthetic_token_batches as j_batches
from repro.fl import pofel_trainer as jpt
from repro.launch.train import append_round_block as j_append
from repro_torch.blockchain.ledger import Ledger
from repro_torch.core import crypto
from repro_torch.data.tokens import TokenBatchSpec, synthetic_token_batches
from repro_torch.fl import pofel_trainer as pt
from repro_torch.launch import train


@pytest.mark.parametrize("batch,seq,vocab,seed", [(8, 64, 512, 0),
                                                  (4, 16, 2048, 3),
                                                  (1, 5, 7, 11)])
def test_synthetic_token_batches_bit_equal(batch, seq, vocab, seed):
    spec, jspec = TokenBatchSpec(batch, seq, vocab), JSpec(batch, seq, vocab)
    assert spec.shapes() == jspec.shapes()
    ours, theirs = synthetic_token_batches(spec, seed), j_batches(jspec, seed)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


def _metrics(rng, C):
    sims = rng.uniform(0.9, 1.0, C).astype(np.float32)
    wv = rng.uniform(0.5, 1.3, C).astype(np.float32)
    scores = rng.normal(size=C).astype(np.float32)
    loss = rng.uniform(5, 7, C).astype(np.float32)
    leader = int(np.argmax(sims))
    port = pt.ConsensusMetrics(torch.from_numpy(loss), torch.from_numpy(sims),
                               torch.tensor(leader, dtype=torch.int32),
                               torch.from_numpy(wv), torch.from_numpy(scores))
    ref = jpt.ConsensusMetrics(jnp.asarray(loss), jnp.asarray(sims),
                               jnp.asarray(leader, jnp.int32),
                               jnp.asarray(wv), jnp.asarray(scores))
    return port, ref


@pytest.mark.parametrize("C", [2, 4])
def test_append_round_block_matches_reference(C):
    rng = np.random.default_rng(C)
    ledger, jledger = Ledger(0), JLedger(0)
    key = crypto.ECDSAKeyPair.generate(b"launcher")
    jkey = jcrypto.ECDSAKeyPair.generate(b"launcher")
    assert key.public_key == jkey.public_key
    for k in range(3):
        port_m, ref_m = _metrics(rng, C)
        block = train.append_round_block(ledger, key, k, port_m)
        jblock = j_append(jledger, jkey, k, ref_m)
        ours, theirs = dataclasses.asdict(block), dataclasses.asdict(jblock)
        assert ours.keys() == theirs.keys()
        for name in ours:
            if name == "leader_signature":
                assert tuple(ours[name]) == tuple(theirs[name])
            else:
                assert ours[name] == theirs[name], name
        assert block.body_bytes() == jblock.body_bytes()
        assert ledger.head_hash == jledger.head_hash
    assert ledger.height == 3 and ledger.verify_chain()


@pytest.mark.parametrize("arch,outer", [("yi-6b", "sgd1"),
                                        ("musicgen-medium", "nesterov")])
def test_train_reduced_verifies_its_chain(arch, outer, capsys):
    run = train.train_reduced(arch, steps=2, n_clusters=4, batch=8, seq=16,
                              seed=0, outer=outer, device="cpu")
    assert run.ledger.height == 2 and run.ledger.verify_chain()
    assert int(run.state.round) == 2
    for m in run.metrics:
        assert m.loss.shape == (4,) and torch.isfinite(m.loss).all()
        assert 0 <= int(m.leader) < 4
    out = capsys.readouterr().out
    assert "chain verified at height 2" in out and "device=cpu" in out


def test_main_takes_the_reference_flags_and_a_device(capsys):
    train.main(["--arch", "rwkv6-1.6b", "--steps", "1", "--clusters", "2",
                "--batch", "4", "--seq", "8", "--device", "cpu"])
    assert "chain verified at height 1" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        train.main(["--arch", "mnist-mlp", "--device", "cpu"])


def test_trainer_modules_import_neither_jax_nor_reference():
    code = ("import sys; import repro_torch.launch.train, "
            "repro_torch.checkpoint, repro_torch.fl.pofel_trainer; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]; print(bad); sys.exit(1 if bad else 0)")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    env = {**os.environ, "PYTHONPATH": src}
    done = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stdout + done.stderr

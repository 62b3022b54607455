"""The sharded consortium of the port against the reference's.

The committee primitives are host protocol: the same inputs give the
same bytes (seeds, keys, payload digests, signatures, wire certificates,
checkpoint blocks) and the same validator verdicts. ``model_digest`` and
the cross-committee Eq. 1 (``ConsortiumRuntime._aggregate_models``,
host float64 numpy) are bit-identical on identical float32 models. The
reference's ``MINI`` consortium (3 committees of 4) runs through the
port's ``api.run_bhfl`` on the CPU under every assertion the reference
test makes of it, and a ``ConsortiumRuntime`` started from the
reference's initial MLP matches the reference's report
(``_torch_scenario_parity.compare_reports``).
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.blockchain.block import GENESIS_HASH as J_GENESIS
from repro.blockchain.block import block_hash as j_block_hash
from repro.blockchain.ledger import Ledger as JLedger
from repro.core import committee as jc
from repro.core.recovery import NodeWAL as JWAL
from repro.core.recovery import WALConflict as JWALConflict
from repro.data.synthetic import make_mnist_like as j_mnist
from repro.fl import consortium as jcons
from repro.fl.hfl_runtime import BHFLConfig as JConfig
from repro.fl.hierarchy import build_hierarchy as j_build
from repro.models.mlp import MLPConfig as JMLPConfig
from repro.sim import Scenario as JScenario
from repro_torch import api
from repro_torch.blockchain.block import GENESIS_HASH as T_GENESIS
from repro_torch.blockchain.block import block_hash as t_block_hash
from repro_torch.blockchain.ledger import Ledger as TLedger
from repro_torch.core import committee as tc
from repro_torch.core.recovery import NodeWAL as TWAL
from repro_torch.core.recovery import WALConflict as TWALConflict
from repro_torch.data.synthetic import make_mnist_like as t_mnist
from repro_torch.fl import consortium as tcons
from repro_torch.fl.adapters import params_from_jax
from repro_torch.fl.hfl_runtime import BHFLConfig as TConfig
from repro_torch.fl.hierarchy import build_hierarchy as t_build
from repro_torch.kernels import ops
from repro_torch.models.mlp import MLPConfig
from repro_torch.sim import Scenario as TScenario

from _torch_scenario_parity import compare_reports

HIDDEN = 32
DIGEST_A = "ab" * 32
DIGEST_B = "cd" * 32

# tests/test_consortium.py's MINI, in both packages
MINI_KW = dict(name="consortium_mini",
               description="3 committees of 4 on a clean bus (test-only)",
               rounds=2, n_nodes=12, clients_per_node=1,
               committees=3, checkpoint_interval=1, n_train=96, n_test=32)
J_MINI, T_MINI = JScenario(**MINI_KW), TScenario(**MINI_KW)

J_PK = types.SimpleNamespace(c=jc, Ledger=JLedger, genesis=J_GENESIS,
                             block_hash=j_block_hash, WAL=JWAL,
                             WALConflict=JWALConflict)
T_PK = types.SimpleNamespace(c=tc, Ledger=TLedger, genesis=T_GENESIS,
                             block_hash=t_block_hash, WAL=TWAL,
                             WALConflict=TWALConflict)


# ---------------------------------------------------------------------------
# Committee primitives
# ---------------------------------------------------------------------------

def _committees(c, n, k, sizes):
    try:
        coms = c.make_committees(n, k, sizes)
    except ValueError as e:
        return "ValueError", str(e)
    return [(m.committee_id, m.members, m.size, m.quorum) for m in coms]


@pytest.mark.parametrize("n,k,sizes", [
    (10, 3, None), (12, 4, None), (256, 8, None), (7, 7, None),
    (10, 0, (2, 5, 3)), (20, 2, (8, 12)),
    (10, 0, (2, 5)), (4, 5, None), (0, 1, None), (5, 0, (0, 5)),
])
def test_make_committees_matches_reference(n, k, sizes):
    assert _committees(tc, n, k, sizes) == _committees(jc, n, k, sizes)


def test_committee_mapping_matches_reference():
    jcom, tcom = jc.make_committees(12, 3)[1], tc.make_committees(12, 3)[1]
    for g in range(12):
        assert (g in tcom) == (g in jcom)
        if g in jcom:
            assert tcom.local_index(g) == jcom.local_index(g)
    assert [tcom.global_id(i) for i in range(4)] == \
        [jcom.global_id(i) for i in range(4)]
    with pytest.raises(KeyError):
        tcom.local_index(0)


def test_committee_seed_matches_reference():
    for seed in (-3, 0, 1, 7, 2 ** 40):
        for cid in range(-1, 9):
            assert tc.committee_seed(seed, cid) == jc.committee_seed(seed,
                                                                     cid)
    assert tc.committee_seed(7, -1) == 7510914623393002459   # the cross bus


def test_committee_keypairs_match_reference():
    for cid, gid in ((0, 0), (0, 5), (1, 5), (3, 255), (7, 31)):
        assert tc.committee_keypair(cid, gid).public_key == \
            jc.committee_keypair(cid, gid).public_key


def _statements(c):
    return [c.CheckpointStatement(0, 1, 3, "00" * 32, DIGEST_A),
            c.CheckpointStatement(2, 0, 0, "ff" * 32, DIGEST_B),
            c.CheckpointStatement(1, 5, 17, "12" * 32, DIGEST_A)]


def test_checkpoint_statements_match_reference():
    for js, ts in zip(_statements(jc), _statements(tc)):
        assert ts.payload_digest() == js.payload_digest()
        assert ts.to_dict() == js.to_dict()
        assert tc.CheckpointStatement.from_dict(js.to_dict()) == ts


def _signed(pk):
    """Every member of committee 0 of 8 nodes in 2 signs statement 0;
    the certificate's wire form, the checkpoint block and its hash."""
    c = pk.c
    coms = c.make_committees(8, 2)
    kps = {g: c.committee_keypair(com.committee_id, g)
           for com in coms for g in com.members}
    stmt = c.CheckpointStatement(0, 0, 1, pk.genesis, DIGEST_A)
    envs = [c.sign_checkpoint(stmt, g, kps[g]) for g in coms[0].members]
    cert = {e.sender: e.signature for e in envs}
    top = pk.Ledger(0)
    blk = c.checkpoint_block(stmt, cert, top, coms[0].members[0],
                             kps[coms[0].members[0]])
    return ([e.signature.to_bytes() for e in envs],
            c.certificate_to_wire(cert), pk.block_hash(blk),
            blk.leader_signature.to_bytes(),
            c.checkpoint_statement_of(blk).to_dict())


def test_signatures_and_blocks_match_reference():
    assert _signed(T_PK) == _signed(J_PK)


def _verdicts(pk):
    """The validator and the certificate check on the reference test's
    cases: full quorum, sub-quorum, foreign signers, a non-member leader,
    a digest or a round changed on the block after signing, another
    epoch's own statement, a certificate moved to another epoch, and the
    WAL refusing a conflicting countersignature."""
    c = pk.c
    coms = c.make_committees(8, 2)
    kps = {g: c.committee_keypair(com.committee_id, g)
           for com in coms for g in com.members}
    pks = {g: kp.public_key for g, kp in kps.items()}
    validator = c.make_checkpoint_validator(
        {m.committee_id: m for m in coms}, pks)
    com = coms[0]

    def block(epoch=0, digest=DIGEST_A, signers=None, leader=None,
              block_digest=None, block_round=None):
        stmt = c.CheckpointStatement(com.committee_id, epoch, 1, pk.genesis,
                                     digest)
        signers = com.members if signers is None else signers
        cert = {g: c.sign_checkpoint(stmt, g, kps[g]).signature
                for g in signers}
        leader = com.members[0] if leader is None else leader
        blk = c.checkpoint_block(stmt, cert, pk.Ledger(0), leader,
                                 kps[leader])
        if block_digest is not None or block_round is not None:
            blk = dataclasses.replace(
                blk, global_model_digest=block_digest or
                blk.global_model_digest,
                round=blk.round if block_round is None else block_round)
        return stmt, cert, blk

    out = []
    cases = [dict(), dict(signers=com.members[:2]),
             dict(signers=com.members[:2] + coms[1].members[:2]),
             dict(leader=coms[1].members[0]),
             dict(block_digest=DIGEST_B), dict(block_round=1),
             dict(epoch=3, digest=DIGEST_B)]
    for case in cases:
        stmt, cert, blk = block(**case)
        out.append((validator(blk),
                    c.verify_checkpoint_certificate(stmt, cert, com, pks)))
    # a certificate carried over to another epoch's statement
    stmt, cert, _ = block(epoch=0)
    moved = c.CheckpointStatement(com.committee_id, 1, 1, pk.genesis,
                                  DIGEST_A)
    out.append(c.verify_checkpoint_certificate(moved, cert, com, pks))
    # the WAL refuses a second, conflicting countersignature for an epoch
    wal = pk.WAL(0)
    c.sign_checkpoint(stmt, 0, kps[0], wal=wal)
    c.sign_checkpoint(stmt, 0, kps[0], wal=wal)        # idempotent
    with pytest.raises(pk.WALConflict):
        c.sign_checkpoint(dataclasses.replace(stmt, global_model_digest=
                                              DIGEST_B), 0, kps[0], wal=wal)
    return out


def test_validator_verdicts_match_reference():
    t = _verdicts(T_PK)
    assert t == _verdicts(J_PK)
    assert t[0] == (0, True) and t[1] == (-1, False)
    assert all(v[0] == -1 for v in t[1:6]) and t[7] is False
    assert t[6] == (0, True)        # another epoch's own statement holds


# ---------------------------------------------------------------------------
# The model crossing committees: digest and cross-committee Eq. 1
# ---------------------------------------------------------------------------

def _models(rng, n):
    return [{"w1": rng.standard_normal((7, 5)).astype(np.float32),
             "b1": rng.standard_normal(5).astype(np.float32),
             "w2": rng.standard_normal((5, 3)).astype(np.float32)}
            for _ in range(n)]


def test_model_digest_is_bit_identical(rng):
    for m in _models(rng, 3):
        assert tcons.model_digest({k: torch.from_numpy(v)
                                   for k, v in m.items()}) == \
            jcons.model_digest({k: jnp.asarray(v) for k, v in m.items()})


def _aggregate(cons, as_array, models, sizes, peers):
    """``_aggregate_models`` on a stand-in consortium: committee c holds
    models[c] over clusters of sizes[c]; ``peers`` maps a receiver to the
    senders whose checkpoints it adopted."""
    shards, committees = [], []
    for cid, (m, s) in enumerate(zip(models, sizes)):
        shard = types.SimpleNamespace(
            global_params={k: as_array(v) for k, v in m.items()},
            clusters=[types.SimpleNamespace(data_size=d) for d in s],
            env=types.SimpleNamespace(note=lambda *a, **k: None))
        shard.adapter = types.SimpleNamespace(
            unflatten=lambda flat, tmpl: ("flat", np.asarray(flat)))
        shards.append(shard)
        committees.append(types.SimpleNamespace(committee_id=cid))
    # the peers' payloads: their sorted-key flattening, float32
    host = [np.concatenate([m[k].reshape(-1) for k in sorted(m)])
            for m in models]
    peer_models = {cid: {s: (host[s], float(sum(sizes[s])))
                         for s in peers.get(cid, ())}
                   for cid in range(len(models))}
    stub = types.SimpleNamespace(committees=committees, shards=shards,
                                 epochs=0)
    cons.ConsortiumRuntime._aggregate_models(stub, peer_models)
    return [s.global_params for s in shards]


def test_aggregate_models_is_bit_identical(rng):
    models = _models(rng, 4)
    sizes = [[30, 31], [17], [44, 2, 9], [5]]
    peers = {0: (1, 2, 3), 1: (0,), 2: (3, 1), 3: ()}
    j = _aggregate(jcons, jnp.asarray, models, sizes, peers)
    t = _aggregate(tcons, torch.from_numpy, models, sizes, peers)
    for cid in range(4):
        if peers[cid]:
            assert j[cid][0] == t[cid][0] == "flat"
            assert j[cid][1].dtype == t[cid][1].dtype == np.float32
            np.testing.assert_array_equal(t[cid][1], j[cid][1])
        else:      # adopted nothing: the model stays as it was
            assert isinstance(t[cid]["w1"], torch.Tensor)


def test_aggregate_models_back_on_the_shard_device():
    """Through a real shard: the Eq. 1 result is unflattened onto the
    shard's device in the adapter's dtypes."""
    run = api.run_bhfl(scenario=T_MINI, seed=0, device="cpu", rounds=1,
                       checkpoint_interval=1)
    for shard in run.runtime.shards:
        for v in shard.global_params.values():
            assert v.device.type == "cpu" and v.dtype == torch.float32
    # every committee adopted both peers, so all three hold one model
    digests = {tcons.model_digest(s.global_params)
               for s in run.runtime.shards}
    assert len(digests) == 1


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------

def test_mini_consortium_end_to_end_on_the_cpu():
    """tests/test_consortium.py::test_mini_consortium_end_to_end through
    the port's api, every assertion of it; the ME kernels' plain versions
    run on the CPU (no launch)."""
    counts = ops.launch_counts()
    run = api.run_bhfl(scenario=T_MINI, seed=0, device="cpu")
    assert ops.launch_counts() == counts
    rep = run.scenario_report
    assert rep is not None and rep.committees == 3
    assert rep.n_nodes == 12 and rep.quorum == 3       # ⌈2·4/3⌉ per shard

    assert [c.committee_id for c in rep.committee_reports] == [0, 1, 2]
    assert rep.committee_reports[0].members == [0, 1, 2, 3]
    assert rep.committee_reports[2].members == [8, 9, 10, 11]
    for c in rep.committee_reports:
        assert c.liveness and c.completed_rounds == 2
        assert c.checkpoints_emitted == 2              # interval=1, 2 rounds
        assert c.checkpoints_merged == 4               # 2 peers x 2 epochs
        assert c.converged and c.safety_violations == 0

    assert rep.liveness and rep.completed_rounds == 2
    assert rep.safety_violations == 0 and rep.converged
    assert rep.top_chain_height == 6                   # 2 epochs x 3 shards
    assert rep.top_chain_converged
    assert rep.cross_shard_checkpoints == 12

    assert {r.committee for r in rep.rounds} == {0, 1, 2}
    c2_rounds = [r for r in rep.rounds if r.committee == 2]
    assert c2_rounds and all(set(r.heads) <= {8, 9, 10, 11}
                             for r in c2_rounds)
    assert set(rep.final_heights) == set(range(12))

    assert "c0:commit" in rep.net_stats
    assert "xshard:checkpoint" in rep.net_stats
    assert rep.net_stats["xshard:checkpoint"]["delivered"] > 0

    assert run.runtime.verify_chains()
    assert run.chain_height == 2                       # shard-0 subchain
    assert len(run.history) == 6                       # K x rounds
    counts = run.leader_counts
    assert set(counts) == set(range(12)) and sum(counts.values()) == 6
    text = rep.summary()
    assert "committee 0" in text and "top-chain:" in text
    d = rep.to_dict()
    assert d["committees"] == 3 and len(d["committee_reports"]) == 3


def test_consortium_matches_reference():
    """``ConsortiumRuntime`` on MINI at hidden 32, dropout 0, every shard
    of the port started from the reference shard's initial MLP."""
    jtr, jte = j_mnist(96, 32, seed=0)
    ttr, tte = t_mnist(96, 32, seed=0)
    jrt = jcons.ConsortiumRuntime(
        j_build(jtr, 12, 1, "iid", seed=0),
        JConfig(n_nodes=12, clients_per_node=1, fel_iterations=1, seed=0,
                mlp=JMLPConfig(hidden=HIDDEN, dropout=0.0)),
        jte, scenario=J_MINI, seed=0)
    trt = tcons.ConsortiumRuntime(
        t_build(ttr, 12, 1, "iid", seed=0),
        TConfig(n_nodes=12, clients_per_node=1, fel_iterations=1, seed=0,
                mlp=MLPConfig(hidden=HIDDEN, dropout=0.0)),
        tte, scenario=T_MINI, seed=0, device="cpu")
    for js, ts in zip(jrt.shards, trt.shards):
        ts.global_params = params_from_jax(
            {k: np.asarray(v) for k, v in js.global_params.items()},
            MLPConfig(hidden=HIDDEN), device="cpu")
    for _ in range(T_MINI.rounds):
        jrt.run_round()
        trt.run_round()
        assert trt.epochs == jrt.epochs
        assert trt.emitted == jrt.emitted and trt.merged == jrt.merged
    jrep = jrt.finalize(J_MINI.name, 0, rounds_requested=jrt.rounds_run)
    trep = trt.finalize(T_MINI.name, 0, rounds_requested=trt.rounds_run)
    compare_reports(jrep.to_dict(), trep.to_dict(), jrt.history,
                    trt.history, committees=trt.committees)
    assert trep.top_chain_height == jrep.top_chain_height == 6
    assert trt.verify_chains()
    for js, ts in zip(jrt.shards, trt.shards):
        for k, v in js.global_params.items():
            np.testing.assert_allclose(ts.global_params[k].numpy(),
                                       np.asarray(v), rtol=0, atol=1e-6)

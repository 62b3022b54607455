"""BTSV, the vote-tally contract and the Stackelberg solver of the port
against the reference, over multi-round histories and with ``present``
masks for absent voters.

Tolerances: BTSV is float32 logs/exps of the same values in another
order, rtol 1e-5 / atol 1e-5; the Stackelberg fixed point, iterated
through float32 sums in another order, rtol 1e-4. Leaders compare
exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.blockchain.smart_contract import VoteSubmission as JSub
from repro.blockchain.smart_contract import VoteTallyContract as JContract
from repro.core import btsv as jb
from repro.core import incentive as jinc
from repro.fl import task as jtask
from repro_torch.blockchain.smart_contract import VoteSubmission as TSub
from repro_torch.blockchain.smart_contract import VoteTallyContract as TContract
from repro_torch.core import btsv as tb
from repro_torch.core import incentive as tinc
from repro_torch.fl import task as ttask

TOL = dict(rtol=1e-5, atol=1e-5)


def _round_inputs(r, n, absent=()):
    votes = r.integers(0, n, size=n)
    P = r.dirichlet(np.ones(n), size=n).astype(np.float32)
    present = np.ones(n, np.float32)
    for i in absent:
        votes[i] = -1
        present[i] = 0.0
    return votes, P, present


@pytest.mark.parametrize("n,absent", [(5, ()), (7, (2, 5)), (1, ())])
def test_btsv_rounds_match_reference(n, absent):
    r = np.random.default_rng(n)
    cfg = jb.BTSVConfig(history=4)
    tcfg = tb.BTSVConfig(history=4)
    jh, th = jb.init_history(n, cfg), tb.init_history(n, tcfg)
    for k in range(6):
        votes, P, present = _round_inputs(r, n, absent if k % 2 else ())
        jp = jnp.asarray(present) if absent and k % 2 else None
        tp = torch.from_numpy(present) if absent and k % 2 else None
        jres, jh = jb.btsv_round(jnp.asarray(votes, jnp.int32),
                                 jnp.asarray(P), jh, cfg, present=jp)
        tres, th = tb.btsv_round(torch.from_numpy(votes), torch.from_numpy(P),
                                 th, tcfg, present=tp)
        assert int(tres.leader) == int(jres.leader)
        for field in ("scores", "weights", "advotes", "chs"):
            t = getattr(tres, field)
            assert t.dtype == torch.float32
            np.testing.assert_allclose(t.numpy(),
                                       np.asarray(getattr(jres, field)),
                                       **TOL)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


def test_absent_voter_is_neutral():
    votes = torch.tensor([1, 1, -1, 0])
    P = torch.full((4, 4), 0.25)
    present = torch.tensor([1.0, 1.0, 0.0, 1.0])
    scores = tb.bts_scores(tb.votes_to_matrix(votes, 4), P,
                           present=present)
    assert float(scores[2]) == 0.0
    assert torch.equal(tb.votes_to_matrix(votes, 4)[2], torch.zeros(4))


@pytest.mark.parametrize("quorum", [None, 4])
def test_contract_tally_matches_reference(quorum):
    n = 5
    r = np.random.default_rng(11)
    jc, tc = JContract(n), TContract(n)
    for k in range(4):
        votes, P, _ = _round_inputs(r, n)
        absent = {k % n} if quorum is not None else set()
        for i in range(n):
            if i in absent:
                continue
            jc.submit(JSub(i, k, int(votes[i]), P[i]))
            tc.submit(TSub(i, k, int(votes[i]), P[i]))
        jres = jc.tally(k, min_submissions=quorum)
        tres = tc.tally(k, min_submissions=quorum)
        assert int(tres.leader) == int(jres.leader)
        for field in ("scores", "weights", "advotes", "chs"):
            t = getattr(tres, field)
            assert t.dtype == torch.float32 and t.device.type == "cpu"
            np.testing.assert_allclose(t.numpy(),
                                       np.asarray(getattr(jres, field)),
                                       **TOL)
        for i in absent:
            assert float(tres.scores[i]) == 0.0


@pytest.mark.parametrize("n", [1, 4, 8])
def test_stackelberg_matches_reference(n):
    r = np.random.default_rng(n)
    gamma = r.uniform(0.008, 0.02, n).astype(np.float32)
    mu = r.uniform(3.0, 7.0, n).astype(np.float32)
    jsol = jinc.stackelberg_equilibrium(
        jinc.NodeParams(jnp.asarray(gamma), jnp.asarray(mu)))
    tsol = tinc.stackelberg_equilibrium(
        tinc.NodeParams(torch.from_numpy(gamma), torch.from_numpy(mu)))
    for field in tsol._fields:
        t = getattr(tsol, field)
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(getattr(jsol,
                                                                 field)),
                                   rtol=1e-4, atol=1e-4)


def test_best_response_matches_reference():
    f_rest = np.array([5.0, 40.0, 0.5], np.float32)
    gamma = np.array([0.01, 0.02, 0.015], np.float32)
    mu = np.array([5.0, 4.0, 6.0], np.float32)
    t = tinc.best_response(torch.from_numpy(f_rest), torch.tensor(120.0),
                           torch.from_numpy(gamma), torch.from_numpy(mu))
    for i in range(3):
        j = jinc.best_response(jnp.asarray(f_rest[i]), jnp.asarray(120.0),
                               jnp.asarray(gamma[i]), jnp.asarray(mu[i]))
        np.testing.assert_allclose(float(t[i]), float(j), rtol=1e-5)


def test_negotiate_task_matches_reference():
    n = 6
    r = np.random.default_rng(0)
    gamma = {i: float(g) for i, g in enumerate(r.uniform(0.008, 0.02, n))}
    mu = {i: 5.0 for i in range(n)}
    args = ("t0", "owner", "digits")
    jag = jtask.negotiate_task(jtask.LearningTask(*args), list(range(n)),
                               gamma, mu)
    tag = ttask.negotiate_task(ttask.LearningTask(*args), list(range(n)),
                               gamma, mu)
    assert tag.participants == jag.participants
    assert tag.task.digest() == jag.task.digest()
    np.testing.assert_allclose(tag.delta_star, jag.delta_star, rtol=1e-4)
    for i in tag.participants:
        np.testing.assert_allclose(tag.f_star[i], jag.f_star[i], rtol=1e-4)
        np.testing.assert_allclose(tag.node_utilities[i],
                                   jag.node_utilities[i], rtol=1e-4,
                                   atol=1e-4)

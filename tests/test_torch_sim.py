"""The simulator of the port against the reference's (``repro.sim``).

The bus and the fault environment are numpy: the same seed and the same
payloads must give the same deliveries, drops, jitter order, retransmits,
gossip, alive sets and partitions, exactly. The scenario runs build
``BHFLRuntime`` + ``sim.build_env`` as ``api.run_bhfl`` does, at hidden
32 with dropout 0, the port starting from the reference's initial MLP.
Their ``ScenarioReport``s are compared by
``_torch_scenario_parity.compare_reports``: at the scenarios' size (one
FEL iteration at lr 1e-3, every model a step from the same init) the
vote ties in float32 in every round, so the fields that follow from the
election are compared only through the port's argmax lying within the
similarity tolerance of the reference's best model and the port electing
its argmax where the reference did. One ``byzantine_third`` run on
label-skewed shards, whose models part, compares most rounds' votes and
leaders exactly.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro import sim as jsim
from repro.data.synthetic import make_mnist_like as j_mnist
from repro.fl.hfl_runtime import BHFLConfig as JConfig
from repro.fl.hfl_runtime import BHFLRuntime as JRuntime
from repro.fl.hierarchy import build_hierarchy as j_build
from repro.models.mlp import MLPConfig as JMLPConfig
from repro_torch import obs as tobs
from repro_torch import sim as tsim
from repro_torch.data.synthetic import make_mnist_like as t_mnist
from repro_torch.fl.adapters import params_from_jax
from repro_torch.fl.hfl_runtime import BHFLConfig as TConfig
from repro_torch.fl.hfl_runtime import BHFLRuntime as TRuntime
from repro_torch.fl.hierarchy import build_hierarchy as t_build
from repro_torch.models.mlp import MLPConfig

from _torch_scenario_parity import drop_keys, compare_reports

HIDDEN = 32
SEED = 0

SCENARIOS = ("byzantine_third", "leader_crash", "edge_churn",
             "commit_withholder", "reveal_equivocator", "forged_envelopes",
             "plagiarist", "crash_restart", "lossy_wan_retry")


# ---------------------------------------------------------------------------
# The bus and the environment, replayed
# ---------------------------------------------------------------------------

def _configs(pk):
    """Bus configurations of both packages, by name: each exercises one
    part of the delivery model."""
    return {
        "clean": pk.NetworkConfig(),
        "lossy": pk.NetworkConfig(link=pk.LinkSpec(base_latency=10.0,
                                                   jitter=8.0,
                                                   drop_rate=0.2)),
        "partition_churn": pk.NetworkConfig(
            link=pk.LinkSpec(base_latency=5.0, jitter=3.0, drop_rate=0.05),
            partitions=(pk.PartitionSpec(groups=((0, 1, 2), (3, 4, 5, 6)),
                                         start_round=1, end_round=3),),
            churn=(pk.ChurnSpec(node=6, down_from=2, down_until=4),)),
        "retry_gossip": pk.NetworkConfig(
            link=pk.LinkSpec(base_latency=5.0, jitter=4.0, drop_rate=0.4),
            retry=pk.RetrySpec(max_retries=3, base_backoff=4.0,
                               backoff_factor=2.0, gossip=True)),
    }


def _event_tuples(rec):
    return [(e.name, e.round, e.node, e.sim_ms, sorted(e.attrs.items()))
            for e in rec.events]


def _drive_network(pk, obs, config_name, committee=None):
    """Five rounds of commit/reveal exchanges, vote transactions and a
    forced crash on a 7-node bus; everything observable, in order."""
    net = pk.SimNetwork(7, _configs(pk)[config_name], seed=11,
                        committee=committee)
    rec = obs.TraceRecorder("bus")
    out = []
    with obs.use_recorder(rec):
        for k in range(5):
            net.set_round(k)
            if k == 3:
                net.force_down(1, until_round=5)
            alive = sorted(net.alive())
            comps = sorted(sorted(c) for c in net.components())
            step = [k, alive, comps,
                    [net.reachable(i, j) for i in range(7) for j in range(7)]]
            for kind in ("commit", "reveal"):
                payloads = {i: f"{kind}-{k}-{i}" for i in alive}
                delays = {alive[-1]: 30.0} if kind == "commit" else None
                dl = net.exchange(kind, payloads, extra_delays=delays)
                step.append([(r, list(dl[r].items())) for r in sorted(dl)])
                step.append(list(net.last_order))
            step.append(sorted(net.tx_landed("vote", alive, quorum=5)))
            step.append(net.now)
            out.append(step)
    return out, {k: dict(v) for k, v in net.stats.items()}, \
        _event_tuples(rec)


@pytest.mark.parametrize("config_name", ["clean", "lossy",
                                         "partition_churn", "retry_gossip"])
def test_network_replays_reference(config_name):
    j = _drive_network(jsim, jobs, config_name)
    t = _drive_network(tsim, tobs, config_name)
    assert t[0] == j[0]
    assert t[1] == j[1]
    assert t[2] == j[2]


def test_committee_bus_replays_reference():
    j = _drive_network(jsim, jobs, "retry_gossip", committee=2)
    t = _drive_network(tsim, tobs, "retry_gossip", committee=2)
    assert t == j
    assert all(dict(e[4]).get("committee") == 2 for e in t[2])


def test_retry_schedule_matches_reference():
    for pk_args in (dict(), dict(max_retries=3, base_backoff=4.0,
                                 backoff_factor=2.0, max_backoff=20.0)):
        jr, tr = jsim.RetrySpec(**pk_args), tsim.RetrySpec(**pk_args)
        assert [tr.backoff(a) for a in range(6)] == \
            [jr.backoff(a) for a in range(6)]
        assert tr.schedule(60.0) == jr.schedule(60.0)
    for bad in (dict(max_retries=-1), dict(backoff_factor=0.5)):
        with pytest.raises(ValueError):
            jsim.RetrySpec(**bad)
        with pytest.raises(ValueError):
            tsim.RetrySpec(**bad)


def _drive_env(pk, name):
    """A scenario's environment without a consensus bound: the queries
    the phases make, round by round, including the adversaries' seeded
    votes and the crash specs."""
    sc = pk.get_scenario(name)
    env = pk.build_env(sc, n_nodes=sc.n_nodes, seed=SEED)
    n = sc.n_nodes
    out = [sorted(env.adversary_ids), env.honest_ids(),
           sorted(env.plagiarist_ids()), env.quorum]
    preds = np.full(n, 1.0 / n, np.float32)
    for k in range(sc.rounds):
        env.begin_round(k)
        alive = sorted(env.alive())
        step = [k, alive, [env.reachable_peers(i) for i in range(n)],
                [env.withholds_commit(i) for i in range(n)],
                [env.withholds_vote(i) for i in range(n)]]
        votes = []
        for i in range(n):
            v = env.adversary_vote(i, k, 0, preds)
            votes.append(None if v is None else (v[0], v[1].tolist()))
        step.append(votes)
        step.append([env.leader_fails(c, k, a) for c in range(n)
                     for a in range(2)])
        dl = env.exchange("commit", k, {i: i for i in alive})
        step.append([(r, list(dl[r])) for r in sorted(dl)])
        step.append(env.last_exchange_order())
        step.append(sorted(env.tx_landed("vote", k, alive)))
        for point in ("after_commit", "after_vote", "after_mint"):
            for node in range(n):
                spec = env.crash_at(node, point, k)
                if spec is not None:
                    step.append((point, node,
                                 env.execute_crash(spec, node)))
        out.append(step)
    out.append(env.events)
    return out


@pytest.mark.parametrize("name", [n for n in jsim.list_scenarios()
                                  if jsim.SCENARIOS[n].committees <= 1])
def test_env_replays_reference(name):
    assert _drive_env(tsim, name) == _drive_env(jsim, name)


# ---------------------------------------------------------------------------
# The scenario registry
# ---------------------------------------------------------------------------

def _plain(x):
    """A scenario field as plain data: dataclasses by their fields,
    adversaries by class name and attributes."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: _plain(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if hasattr(x, "__dict__"):
        return (type(x).__name__,
                {k: _plain(v) for k, v in sorted(vars(x).items())})
    return x


def test_registry_names_match_reference():
    assert tsim.list_scenarios() == jsim.list_scenarios()
    assert len(tsim.list_scenarios()) == 20
    assert tsim.list_scenarios(include_slow=False) == \
        jsim.list_scenarios(include_slow=False)


@pytest.mark.parametrize("name", jsim.list_scenarios())
def test_registry_fields_match_reference(name):
    assert _plain(tsim.get_scenario(name)) == _plain(jsim.get_scenario(name))


# ---------------------------------------------------------------------------
# Scenario runs: the port's runtime against the reference's
# ---------------------------------------------------------------------------

# label-skewed shards at lr 0.5: the nodes' models part, so the vote's
# top-2 margin clears 10 x the similarity tolerance in most rounds (the
# reference's byzantine_third: 5 of 6) and those compare exactly
CLEAR_MARGIN = dict(distribution="label", lr=0.5)


def _runtime(pk_config, pk_runtime, build, mnist, mlp_cfg, sc, engine,
             distribution="iid", **kw):
    train, test = mnist(sc.n_train, sc.n_test, seed=SEED)
    lr = {"lr": kw.pop("lr")} if "lr" in kw else {}
    cfg = pk_config(n_nodes=sc.n_nodes, clients_per_node=sc.clients_per_node,
                    fel_iterations=sc.fel_iterations, seed=SEED,
                    engine=engine, mlp=mlp_cfg(hidden=HIDDEN, dropout=0.0),
                    **lr)
    clusters = build(train, sc.n_nodes, sc.clients_per_node, distribution,
                     seed=SEED)
    return pk_runtime(clusters, cfg, test, **kw)


def _play(rt, sim, sc):
    """``api.run_bhfl``'s scenario wiring on a built runtime."""
    env = sim.build_env(sc, n_nodes=sc.n_nodes, seed=SEED)
    rt.env = env
    env.bind(rt.consensus)
    rt.plagiarists |= env.plagiarist_ids()
    for _ in range(sc.rounds):
        rt.run_round()
    return env.finalize(scenario=sc.name, seed=SEED,
                        rounds_requested=len(rt.history))


@functools.lru_cache(maxsize=None)
def _reference(name, clear_margin=False):
    sc = jsim.get_scenario(name)
    rt = _runtime(JConfig, JRuntime, j_build, j_mnist, JMLPConfig, sc,
                  "reference", **(CLEAR_MARGIN if clear_margin else {}))
    init = {k: np.asarray(v) for k, v in rt.global_params.items()}
    return init, rt, _play(rt, jsim, sc)


def _port(name, init, engine="reference", clear_margin=False):
    sc = tsim.get_scenario(name)
    rt = _runtime(TConfig, TRuntime, t_build, t_mnist, MLPConfig, sc, engine,
                  device="cpu", **(CLEAR_MARGIN if clear_margin else {}))
    rt.global_params = params_from_jax(init, MLPConfig(hidden=HIDDEN),
                                       device="cpu")
    return rt, _play(rt, tsim, sc)


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_report_matches_reference(name):
    init, jrt, jrep = _reference(name)
    trt, trep = _port(name, init)
    compare_reports(jrep.to_dict(), trep.to_dict(), jrt.history, trt.history)
    assert trep.liveness and trep.safety_violations == 0 and trep.converged
    for led in trt.consensus.ledgers:
        assert led.verify_chain()


def test_bribery_with_a_clear_margin_matches_reference():
    """``byzantine_third`` where the models part: the rounds whose vote
    does not tie compare votes and leaders exactly, and BTSV elects the
    similarity argmax every round, bribed votes notwithstanding."""
    init, jrt, jrep = _reference("byzantine_third", clear_margin=True)
    trt, trep = _port("byzantine_third", init, clear_margin=True)
    tied = compare_reports(jrep.to_dict(), trep.to_dict(), jrt.history,
                           trt.history)
    assert tied < len(trep.rounds)
    assert trep.liveness and trep.safety_violations == 0 and trep.converged
    assert trep.argmax_leader_rate == jrep.argmax_leader_rate == 1.0


@pytest.fixture
def one_thread():
    """The batched engine against the loop on one CPU thread (MKL rounds
    a float32 GEMM by its thread count; tests/test_torch_batched_fel.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_batched_engine_scenario_matches_loop(one_thread, monkeypatch):
    """``edge_churn`` on the batched engine: node 5 is down for rounds
    2-3, and its row of W(k) is the global model it went down with, on
    the device; the report equals the loop's but for the head hashes."""
    init, _, _ = _reference("edge_churn")
    loop_rt, loop_rep = _port("edge_churn", init)
    rows = []
    real = TRuntime._fel_models_batched

    def spy(self, round_seed, down=None):
        before = self._global_flat.clone()
        models = real(self, round_seed, down=down)
        rows.append((sorted(down or ()), before, models))
        return models

    monkeypatch.setattr(TRuntime, "_fel_models_batched", spy)
    bat_rt, bat_rep = _port("edge_churn", init, engine="batched")
    assert bat_rt.engine == "batched"
    assert [d for d, _, _ in rows] == [[], [], [5], [5], [], []]
    for down, before, models in rows:
        for i in down:
            assert torch.equal(models[i], before)
    # on one thread the engines' similarities are bit-identical, so even
    # the tied votes fall the same way: the whole report is the loop's
    for ml, mb in zip(loop_rt.history, bat_rt.history):
        np.testing.assert_array_equal(mb.consensus.similarities,
                                      ml.consensus.similarities)
    ld, bd = loop_rep.to_dict(), bat_rep.to_dict()
    assert [drop_keys(r, ("heads",)) for r in bd["rounds"]] == \
        [drop_keys(r, ("heads",)) for r in ld["rounds"]]
    skip = ("rounds", "final_heads", "obs_metrics")
    assert drop_keys(bd, skip) == drop_keys(ld, skip)
    assert bat_rep.liveness and bat_rep.converged
    assert bat_rep.rounds_to_recover == loop_rep.rounds_to_recover == 2

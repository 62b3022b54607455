"""The seven scripts of ``examples_torch/`` against their twins in
``examples/``, on the CPU, in one process: each port script through its
``main(argv)`` with ``--device cpu``, each reference script through
``runpy`` with the same arguments.

The port's scripts draw their initial parameters from their own
generators, as ``jax.random`` draws cannot be reproduced in torch (Port
rule 4); here the port is given the reference's instead (the MLP's
``mlp_init``, the trainer's ``init_train_state``, the serving models'
``Model.init``), and both packages train the MLP with dropout 0. The
numpy data and seeds are the scripts' own. Then:

* votes, leader ids and (where the weights are bit-identical, as in the
  quickstart) block digests compare exactly wherever the vote is clear:
  the reference's top-2 similarity margin over ten times the similarity
  tolerance, or, in a trained round, over twice the two packages'
  largest similarity difference; in a round tied closer than that the
  port's leader holds one of the reference's best similarities;
* floats at the port's tolerances for each path: similarities atol 1e-5,
  accuracy atol 1e-6 and loss rtol 1e-4 for the MLP rounds
  (``tests/test_torch_e2e.py``); the scenario reports by
  ``tests/_torch_scenario_parity.py``; the bfloat16 trainer's losses
  within 5e-2 and similarities within 1e-4
  (``tests/test_torch_pofel_trainer.py``);
* serving gives the reference's greedy tokens.

Sizes: the quickstart, ``full_system`` and ``attack_simulation`` at the
scripts' own sizes; ``bhfl_train`` at 3 nodes × 2 clients, 2 rounds of
one FEL iteration; the trainer at 2 steps; ``serve_llm`` at
starcoder2-3b, batch 2; ``batched_serving`` at temperature 0.
"""

from __future__ import annotations

import importlib.util
import re
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.api as j_api
import repro.fl.pofel_trainer as j_pt
import repro.launch.train as j_train
from _torch_scenario_parity import compare_reports
from repro.configs import get_config as j_get_config
from repro.models.mlp import MLPConfig as JMLPConfig
from repro.models.mlp import mlp_init as j_mlp_init
from repro.models.model_api import Model as JModel
from repro_torch import api as t_api
from repro_torch.configs import get_config
from repro_torch.fl import adapters as t_adapters
from repro_torch.fl import pofel_trainer as t_pt
from repro_torch.models.mlp import MLPConfig
from repro_torch.models.model_api import Model
from repro_torch.models.ssm_models import rwkv_params_from_jax
from repro_torch.models.transformer import transformer_params_from_jax

REPO = Path(__file__).resolve().parents[1]
SIM_ATOL = 1e-5
TRAIN_LOSS_TOL = 5e-2
TRAIN_SIM_ATOL = 1e-4
SCRIPTS = ["quickstart", "bhfl_train", "full_system", "attack_simulation",
           "llm_pofel_round", "serve_llm", "batched_serving"]


def _port_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", REPO / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_reference(name, argv, monkeypatch, capsys) -> str:
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    runpy.run_path(str(REPO / "examples" / f"{name}.py"),
                   run_name="__main__")
    return capsys.readouterr().out


def _run_port(name, argv, capsys):
    out = _port_script(name).main([*argv, "--device", "cpu"])
    return out, capsys.readouterr().out


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def mlp_runs(monkeypatch):
    """Both packages' ``api.run_bhfl`` train the MLP with dropout 0 and
    record their runs; the port's MLP starts from the reference's
    ``mlp_init`` under ``jax.random.key(seed)``."""
    runs = {"reference": [], "port": []}

    def recording(orig, mlp_cfg, store):
        def run_bhfl(*a, **k):
            if k.get("model", "mlp") == "mlp" and "cfg" not in k:
                k["mlp"] = mlp_cfg
            run = orig(*a, **k)
            store.append(run)
            return run
        return run_bhfl

    monkeypatch.setattr(j_api, "run_bhfl", recording(
        j_api.run_bhfl, JMLPConfig(dropout=0.0), runs["reference"]))
    monkeypatch.setattr(t_api, "run_bhfl", recording(
        t_api.run_bhfl, MLPConfig(dropout=0.0), runs["port"]))

    def reference_init(self, generator):
        jp = j_mlp_init(JMLPConfig(*self.cfg),
                        jax.random.key(generator.initial_seed()))
        return t_adapters.params_from_jax(
            {k: np.asarray(v) for k, v in jp.items()}, self.cfg,
            device=self.device)
    monkeypatch.setattr(t_adapters.MLPAdapter, "init", reference_init)
    return runs


def _leader_clear(sims, atol=SIM_ATOL) -> bool:
    top2 = np.sort(np.asarray(sims, np.float64))[-2:]
    return top2[1] - top2[0] >= 10 * atol


def _compare_rounds(jrun, trun):
    """Round by round: similarities, accuracy and loss at the tolerances.
    At the §7.1 learning rate the models barely part, and the reference's
    top-2 similarity margin is 1e-6 to 3e-5: under the tolerance. So the
    vote is compared where the margin exceeds twice the two packages'
    largest similarity difference in that round (then the argmax cannot
    differ): votes and the leader exactly. Elsewhere the port's leader
    must hold one of the reference's best similarities to within the
    tolerance. Returns how many rounds were compared exactly."""
    assert len(trun.history) == len(jrun.history)
    exact = 0
    for mj, mt in zip(jrun.history, trun.history):
        sj = np.asarray(mj.consensus.similarities, np.float64)
        st = np.asarray(mt.consensus.similarities, np.float64)
        np.testing.assert_allclose(st, sj, rtol=0, atol=SIM_ATOL)
        np.testing.assert_allclose(mt.test_accuracy, mj.test_accuracy,
                                   atol=1e-6)
        np.testing.assert_allclose(mt.test_loss, mj.test_loss, rtol=1e-4)
        top2 = np.sort(sj)[-2:]
        if top2[1] - top2[0] > 2 * np.abs(st - sj).max():
            exact += 1
            assert mt.leader_id == mj.leader_id
            np.testing.assert_array_equal(mt.consensus.votes,
                                          np.asarray(mj.consensus.votes))
        else:
            assert sj[mt.leader_id] >= sj.max() - SIM_ATOL
    assert trun.chain_valid and jrun.chain_valid
    assert trun.chain_height == jrun.chain_height
    return exact


def test_every_reference_script_has_a_port_that_imports_no_jax():
    ours = sorted(p.stem for p in (REPO / "examples_torch").glob("*.py"))
    assert ours == sorted(p.stem for p in (REPO / "examples").glob("*.py"))
    assert sorted(SCRIPTS) == ours
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.M)
    for name in ours:
        text = (REPO / "examples_torch" / f"{name}.py").read_text()
        assert not pat.search(text), name
        assert '"--device", default="cuda"' in text, name


@pytest.mark.parametrize("name", SCRIPTS)
def test_scripts_stop_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _port_script(name).main([])


def test_quickstart_matches_reference(monkeypatch, capsys):
    recorded = []
    orig = j_api.PoFELConsensus.run_round

    def run_round(self, *a, **k):
        recorded.append(orig(self, *a, **k))
        return recorded[-1]
    monkeypatch.setattr(j_api.PoFELConsensus, "run_round", run_round)
    ref_out = _run_reference("quickstart", [], monkeypatch, capsys)
    base = j_mlp_init(JMLPConfig(hidden=32), jax.random.key(0))
    script = _port_script("quickstart")
    monkeypatch.setattr(script, "mlp_init", lambda cfg, gen, device: {
        k: torch.from_numpy(np.array(v)).to(device) for k, v in base.items()})
    (trec, consensus), out = script.main(["--device", "cpu"]), \
        capsys.readouterr().out
    jrec = recorded[0]
    np.testing.assert_allclose(trec.similarities,
                               np.asarray(jrec.similarities), rtol=0,
                               atol=SIM_ATOL)
    assert _leader_clear(jrec.similarities)
    assert trec.leader_id == jrec.leader_id
    np.testing.assert_array_equal(trec.votes, np.asarray(jrec.votes))
    np.testing.assert_allclose(trec.btsv.weights.numpy(),
                               np.asarray(jrec.btsv.weights), rtol=1e-6)
    # the same models, bit for bit, and their aggregate
    assert trec.block.model_digests == jrec.block.model_digests
    assert trec.block.global_model_digest == jrec.block.global_model_digest
    assert consensus.chain[0].votes == jrec.block.votes
    # every printed line but the similarities, which print rounded
    same = [ln for ln in out.splitlines()
            if not ln.startswith("cosine similarities")]
    assert same == [ln for ln in ref_out.splitlines()
                    if not ln.startswith("cosine similarities")]
    assert len(same) == len(out.splitlines()) - 1


def test_bhfl_train_matches_reference(mlp_runs, monkeypatch, capsys):
    argv = ["--nodes", "3", "--clients", "2", "--rounds", "2",
            "--fel-iters", "1", "--distribution", "label"]
    _run_reference("bhfl_train", argv, monkeypatch, capsys)
    run, out = _run_port("bhfl_train", argv, capsys)
    assert run is mlp_runs["port"][0]
    assert _compare_rounds(mlp_runs["reference"][0], run) >= 1
    assert f"chain verified at height {run.chain_height} ✓" in out


def test_full_system_matches_reference(mlp_runs, monkeypatch, capsys):
    _run_reference("full_system", [], monkeypatch, capsys)
    run, out = _run_port("full_system", [], capsys)
    jrun = mlp_runs["reference"][0]
    clear = _compare_rounds(jrun, run)
    agree, jagree = run.agreement, jrun.agreement
    assert agree.participants == jagree.participants
    assert agree.delta_star == pytest.approx(jagree.delta_star, rel=1e-9)
    if clear == len(run.history):
        assert run.rewards.totals() == pytest.approx(
            jrun.rewards.totals(), rel=1e-9)
    assert "chain verified: True" in out


def test_attack_simulation_matches_reference(mlp_runs, monkeypatch, capsys):
    _run_reference("attack_simulation", [], monkeypatch, capsys)
    reports, out = _run_port("attack_simulation", [], capsys)
    assert "HCDS + BTSV suppressed all three attacks ✓" in out
    assert list(reports) == ["plagiarist", "bribery_targeted",
                             "bribery_random"]
    for name, jrun, trun in zip(reports, mlp_runs["reference"],
                                mlp_runs["port"]):
        assert trun.scenario_report is reports[name]
        compare_reports(jrun.scenario_report.to_dict(),
                        trun.scenario_report.to_dict(),
                        jrun.history, trun.history)


def test_llm_pofel_round_matches_reference(monkeypatch, capsys):
    states, metrics = [], []
    orig_init, orig_block = j_pt.init_train_state, j_train.append_round_block

    def init(*a, **k):
        states.append(orig_init(*a, **k))
        return states[-1]

    def block(ledger, keypair, k, m):
        metrics.append(jax.tree.map(np.asarray, m))
        return orig_block(ledger, keypair, k, m)
    monkeypatch.setattr(j_pt, "init_train_state", init)
    monkeypatch.setattr(j_train, "append_round_block", block)
    _run_reference("llm_pofel_round", ["--steps", "2"], monkeypatch, capsys)
    monkeypatch.setattr(t_pt, "init_train_state",
                        lambda model, cfg, gen: t_pt.train_state_from_jax(
                            jax.tree.map(np.asarray, states[0]), model))
    run, out = _run_port("llm_pofel_round", ["--steps", "2"], capsys)
    assert "done: 2 PoFEL rounds, chain verified at height 2" in out
    assert run.ledger.height == 2 and run.ledger.verify_chain()
    for mj, mt in zip(metrics, run.metrics, strict=True):
        np.testing.assert_allclose(float(mt.loss.mean()),
                                   float(np.mean(mj.loss)),
                                   atol=TRAIN_LOSS_TOL)
        np.testing.assert_allclose(mt.similarities.numpy(),
                                   mj.similarities, rtol=0,
                                   atol=TRAIN_SIM_ATOL)
        sj = np.asarray(mj.similarities, np.float64)
        top2 = np.sort(sj)[-2:]
        diff = np.abs(mt.similarities.numpy() - sj).max()
        if top2[1] - top2[0] > 2 * diff:
            assert int(mt.leader) == int(mj.leader)
        else:
            assert sj[int(mt.leader)] >= sj.max() - TRAIN_SIM_ATOL


def _printed_tokens(text: str) -> dict:
    return {int(m[1]): [int(t) for t in m[2].split(",")]
            for m in re.finditer(r"req(\d+)[^:]*: \[([0-9, ]+)\]", text)}


def _reference_params(arch: str, seed: int):
    jp = JModel(j_get_config(arch).reduced()).init(jax.random.key(seed))
    cfg = get_config(arch).reduced()
    conv = rwkv_params_from_jax if cfg.rwkv else transformer_params_from_jax
    return conv(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def test_serve_llm_matches_reference(monkeypatch, capsys):
    argv = ["--arch", "starcoder2-3b", "--batch", "2"]
    ref = _printed_tokens(_run_reference("serve_llm", argv, monkeypatch,
                                         capsys))
    script = _port_script("serve_llm")
    params = _reference_params("starcoder2-3b", 0)
    serve = script.serve_reduced
    monkeypatch.setattr(script, "serve_reduced",
                        lambda *a, **k: serve(*a, params=params, **k))
    run = script.main([*argv, "--device", "cpu"])
    got = _printed_tokens(capsys.readouterr().out)
    assert sorted(ref) == [0, 1]
    assert got == ref
    assert [run.tokens[r].tolist() for r in (0, 1)] == [ref[0], ref[1]]


def test_batched_serving_matches_reference(monkeypatch, capsys):
    argv = ["--temperature", "0"]
    ref_out = _run_reference("batched_serving", argv, monkeypatch, capsys)
    params = _reference_params("yi-6b", 0)
    monkeypatch.setattr(Model, "init", lambda self, gen: params)
    completions, out = _run_port("batched_serving", argv, capsys)
    ref = _printed_tokens(ref_out)
    assert sorted(ref) == [0, 1, 2]
    assert {c.request_id: c.tokens for c in completions} == ref
    finished = re.findall(r"req\d+ \[(\w+) *\]", ref_out)
    assert [c.finished_by for c in completions] == finished

"""The port's obs exporters, profiler and CLIs against the reference's.

``repro.obs`` imports no JAX, so this file compares the two packages
directly and imports none. One fixed script of spans, events and metrics
drives a ``TraceRecorder`` of each package on the same fake clock; the
Chrome trace, the JSONL event log, the profile (percentiles, critical
paths, ``format_summary``) and the ``python -m ... obs`` CLI must give
the same output (the summary's header names the port's package). The
sim CLI is covered by its ``--list``, one scenario of the ``--fast`` set
on the CPU with its trace and event files, and its refusal to run
without a card unless asked for the CPU.
"""

import json

import pytest
import torch

import repro.obs.__main__ as j_obs_cli
import repro.obs.recorder as j_recorder
import repro_torch.obs.__main__ as t_obs_cli
import repro_torch.obs.recorder as t_recorder
from repro import obs as jobs
from repro_torch import obs as tobs
from repro_torch.sim import SCENARIOS, list_scenarios
from repro_torch.sim import runner


def _as_reference(text):
    """The port's summary names its own package in its header line."""
    return text.replace("# repro_torch.obs summary", "# repro.obs summary",
                        1)


class _Clock:
    """A perf_counter that steps by uneven, fixed amounts."""

    def __init__(self):
        self.t, self.i = 100.0, 0

    def perf_counter(self):
        self.i += 1
        self.t += 0.0007 * (1 + self.i % 5)
        return self.t


def _script(rec, k0):
    """Two rounds of a networked PoFEL round's span tree, with events,
    a raising phase unwound, and metrics."""
    for k in (k0, k0 + 1):
        rec.open_span("round", cat="runtime", round=k, sim_now=10.0 * k)
        with rec.span("begin_round", round=k, sim_now=10.0 * k):
            rec.event("node_rejoined", round=k, node=3, sim_ms=10.0 * k,
                      wal_records=2)
        with rec.span("fel", round=k, engine="reference"):
            pass
        rec.open_span("consensus", cat="consensus", round=k,
                      sim_now=10.0 * k + 1)
        for ph, dt in (("commit_reveal", 3.0), ("model_evaluation", 0.5),
                       ("vote_collection", 2.0)):
            rec.open_span("phase:" + ph, cat="consensus", round=k,
                          sim_now=10.0 * k + 1)
            for node in (0, 2):
                rec.open_span("net:" + ph, cat="network", round=k,
                              node=node, sim_now=10.0 * k + 1, kind=ph)
                rec.event("net_delivery", round=k, node=node,
                          sim_ms=10.0 * k + dt, kind=ph, sender=1 - node,
                          bus_seq=node + k)
                rec.close_span(sim_now=10.0 * k + dt, delivered=1)
            rec.counter(f"net.{ph}.sent", 2)
            rec.observe("phase_ms", dt)
            rec.close_span(sim_now=10.0 * k + 1 + dt)
        if k == k0 + 1:
            depth = rec.depth()
            rec.open_span("phase:tally", cat="consensus", round=k)
            rec.event("envelope_rejected", round=k, node=4,
                      sim_ms=10.0 * k + 7, reason="forged-envelope")
            rec.unwind(depth, error="QuorumNotReached")
        rec.close_span(sim_now=10.0 * k + 8)
        rec.gauge("chain_height", k)
        rec.close_span(sim_now=10.0 * k + 9, aborted=False)
    rec.event("round_aborted", round=k0 + 2, sim_ms=None, reason="quorum")


def _traces(obs, recorder_module, monkeypatch):
    monkeypatch.setattr(recorder_module, "time", _Clock())
    out = []
    for label, k0 in (("scenario-a", 0), ("scenario-b", 5)):
        rec = obs.TraceRecorder(label)
        with obs.use_recorder(rec):
            _script(rec, k0)
        out.append((label, rec))
    return out


@pytest.fixture
def both(monkeypatch):
    return (_traces(jobs, j_recorder, monkeypatch),
            _traces(tobs, t_recorder, monkeypatch))


def test_chrome_trace_matches_reference(both, tmp_path):
    jt, tt = both
    assert tobs.chrome_trace(tt) == jobs.chrome_trace(jt)
    tobs.write_chrome_trace(str(tmp_path / "t.json"), tt)
    jobs.write_chrome_trace(str(tmp_path / "j.json"), jt)
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()
    assert tobs.load_trace(str(tmp_path / "t.json")) == \
        jobs.load_trace(str(tmp_path / "j.json"))


def test_events_jsonl_matches_reference(both, tmp_path):
    jt, tt = both
    assert tobs.events_jsonl(tt) == jobs.events_jsonl(jt)
    tobs.write_events_jsonl(str(tmp_path / "t.jsonl"), tt)
    jobs.write_events_jsonl(str(tmp_path / "j.jsonl"), jt)
    assert (tmp_path / "t.jsonl").read_bytes() == \
        (tmp_path / "j.jsonl").read_bytes()
    assert tobs.events_to_trace(str(tmp_path / "t.jsonl")) == \
        jobs.events_to_trace(str(tmp_path / "j.jsonl"))


def test_metrics_match_reference(both):
    jt, tt = both
    for (_, j), (_, t) in zip(jt, tt):
        assert t.metrics_snapshot() == j.metrics_snapshot()


@pytest.mark.parametrize("clock", ["wall", "sim"])
def test_profile_matches_reference(both, clock):
    jt, tt = both
    j = jobs.chrome_trace(jt)
    t = tobs.chrome_trace(tt)
    assert tobs.phase_percentiles(t, clock) == \
        jobs.phase_percentiles(j, clock)
    assert tobs.critical_paths(t, clock) == jobs.critical_paths(j, clock)
    text = tobs.format_summary(t, clock, 3)
    assert _as_reference(text) == jobs.format_summary(j, clock, 3)
    assert "commit_reveal" in text


def test_obs_cli_matches_reference(both, tmp_path, capsys):
    jt, tt = both
    tobs.write_chrome_trace(str(tmp_path / "trace.json"), tt)
    tobs.write_events_jsonl(str(tmp_path / "events.jsonl"), tt)
    outs = []
    for cli in (t_obs_cli, j_obs_cli):
        assert cli.main(["summarize", str(tmp_path / "trace.json"),
                         "--clock", "sim", "--top", "2"]) == 0
        assert cli.main(["convert", str(tmp_path / "events.jsonl"), "-o",
                         str(tmp_path / f"{cli.__name__}.json")]) == 0
        text = capsys.readouterr().out
        outs.append((_as_reference(text.split("wrote")[0]),
                     (tmp_path / f"{cli.__name__}.json").read_text()))
    assert outs[0] == outs[1]


def test_sim_cli_lists_the_registry(capsys):
    assert runner.main(["--device", "cpu", "--list"]) == 0
    lines = capsys.readouterr().out.splitlines()
    singles = [n for n in list_scenarios() if SCENARIOS[n].committees <= 1]
    shards = [n for n in list_scenarios() if SCENARIOS[n].committees > 1]
    assert lines[0] == "# single-committee"
    assert lines[1 + len(singles)] == "# consortium (sharded)"
    assert [ln.split(":")[0].split(" ")[0]
            for ln in lines[1:1 + len(singles)]] == singles
    assert [ln.split(" ")[0] for ln in lines[2 + len(singles):]] == shards
    assert lines[2 + len(singles)].startswith(
        "consortium_256 [slow] [K=8, N=256]: The scale run")


def test_sim_cli_runs_a_fast_scenario_on_the_cpu(tmp_path, capsys):
    assert not SCENARIOS["ideal"].slow
    paths = {k: str(tmp_path / f"out.{k}")
             for k in ("json", "trace", "events")}
    rc = runner.main(["--device", "cpu", "--scenario", "ideal", "--seed",
                      "1", "--json", paths["json"], "--trace",
                      paths["trace"], "--events", paths["events"]])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out.startswith("PASS ideal: 4/4 rounds, liveness=ok")
    rep = json.load(open(paths["json"]))["reports"]["ideal"]
    assert rep["liveness"] and rep["safety_violations"] == 0
    trace = tobs.load_trace(paths["trace"])
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"round", "fel", "phase:model_evaluation", "net:commit"} <= names
    assert "model_evaluation" in tobs.format_summary(trace)
    with open(paths["events"]) as f:
        assert all(json.loads(ln)["scenario"] == "ideal" for ln in f)


def test_sim_cli_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(runner, "run_scenario",
                        lambda *a, **k: ran.append(a))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.main(["--scenario", "ideal"])
    with pytest.raises(SystemExit):
        runner.main(["--device", "cuda", "--scenario", "ideal"])
    assert ran == []


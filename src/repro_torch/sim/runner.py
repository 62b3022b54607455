"""Scenario runner: wire a :class:`Scenario` into a full BHFL run.

Library use::

    from repro_torch import sim
    report = sim.run_scenario("byzantine_third", seed=0)
    assert report.liveness and report.safety_violations == 0

CLI, on the CUDA card (``--device cpu`` runs it on the CPU)::

    PYTHONPATH=src python -m repro_torch.sim --fast --json report.json
    PYTHONPATH=src python -m repro_torch.sim --scenario leader_crash
    PYTHONPATH=src python -m repro_torch.sim --list
    PYTHONPATH=src python -m repro_torch.sim --scenario byzantine_third \
        --trace trace.json --events events.jsonl

``--trace`` writes a Chrome/Perfetto trace of every scenario in the
sweep (one process per scenario); ``--events`` the deterministic JSONL
event log. Both flush whatever was captured even when a scenario FAILs
mid-run — the partial trace is exactly the debugging artifact you want.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, Optional, Union

from repro_torch import obs, resolve_device
from repro_torch.sim.network import SimEnv, SimNetwork
from repro_torch.sim.report import ScenarioReport
from repro_torch.sim.scenarios import (SCENARIOS, Scenario, get_scenario,
                                       list_scenarios)


def build_env(scenario: Scenario, n_nodes: Optional[int] = None,
              seed: int = 0) -> SimEnv:
    """The SimEnv for one run of ``scenario`` (fresh bus, seeded rng)."""
    n = n_nodes if n_nodes is not None else scenario.n_nodes
    network = SimNetwork(n, scenario.net, seed=seed)
    return SimEnv(network, scenario.adversaries,
                  quorum=scenario.quorum or None, seed=seed)


def run_scenario(scenario: Union[str, Scenario], seed: int = 0,
                 rounds: Optional[int] = None,
                 **run_bhfl_kwargs: Any) -> ScenarioReport:
    """Run one named (or ad-hoc) scenario end-to-end and return its report.

    Thin wrapper over ``api.run_bhfl(scenario=...)`` — the facade owns the
    wiring so a scenario run and a plain run share one code path.
    """
    from repro_torch import api
    run = api.run_bhfl(scenario=scenario, seed=seed, rounds=rounds,
                       **run_bhfl_kwargs)
    assert run.scenario_report is not None
    return run.scenario_report


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", action="append", default=None,
                    help="scenario name (repeatable); default: --fast set")
    ap.add_argument("--all", action="store_true",
                    help="run every registered scenario")
    ap.add_argument("--fast", action="store_true",
                    help="run the non-slow scenarios (the CI smoke set)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None,
                    help="write all reports to this JSON file")
    ap.add_argument("--trace", default=None,
                    help="write a Chrome/Perfetto trace (trace_event JSON) "
                         "of the sweep to this path")
    ap.add_argument("--events", default=None,
                    help="write the deterministic JSONL obs event log "
                         "to this path")
    ap.add_argument("--list", action="store_true",
                    help="list registered scenarios and exit")
    ap.add_argument("--device", choices=("cpu",), default=None,
                    help="run on the CPU (default: the CUDA card, which "
                         "must be there)")
    args = ap.parse_args(argv)
    # resolved before any scenario runs: with no card this raises here
    # instead of failing every scenario of the sweep one by one
    device = resolve_device(args.device)

    if args.list:
        # group by topology: single-committee first, then the sharded
        # consortium scenarios (committees > 1) with their K/N shape
        singles = [n for n in list_scenarios()
                   if SCENARIOS[n].committees <= 1]
        consortiums = [n for n in list_scenarios()
                       if SCENARIOS[n].committees > 1]
        print("# single-committee")
        for name in singles:
            s = SCENARIOS[name]
            flag = " [slow]" if s.slow else ""
            print(f"{name}{flag}: {s.description}")
        if consortiums:
            print("# consortium (sharded)")
            for name in consortiums:
                s = SCENARIOS[name]
                flag = " [slow]" if s.slow else ""
                shape = f" [K={s.committees}, N={s.n_nodes}]"
                print(f"{name}{flag}{shape}: {s.description}")
        return 0

    if args.all:
        names = list(list_scenarios())
    elif args.scenario:
        names = args.scenario
    else:
        names = list(list_scenarios(include_slow=False))

    tracing = bool(args.trace or args.events)
    traces: list = []       # (scenario, TraceRecorder), FAIL rows included
    reports: Dict[str, Any] = {}
    failures = 0
    for name in names:
        rec = obs.TraceRecorder(name) if tracing else obs.NullRecorder()
        try:
            with obs.use_recorder(rec):
                report = run_scenario(name, seed=args.seed,
                                      device=device)
        except Exception as e:
            # a scenario that blows up mid-run is one FAIL row in the
            # sweep, not a traceback that aborts every scenario after it —
            # and everything traced before the raise still gets flushed
            failures += 1
            if tracing:
                rec.unwind(0, error=type(e).__name__)
                traces.append((name, rec))
            reports[name] = {"error": f"{type(e).__name__}: {e}"}
            print(f"FAIL {name}: raised {type(e).__name__}: {e}")
            continue
        if tracing:
            traces.append((name, rec))
        reports[name] = report.to_dict()
        ok = (report.liveness and report.safety_violations == 0
              and report.converged)
        failures += 0 if ok else 1
        print(("PASS " if ok else "FAIL ") + report.summary())
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"seed": args.seed, "reports": reports}, f, indent=2,
                      default=str)
        print(f"wrote {args.json}")
    if args.trace:
        obs.write_chrome_trace(args.trace, traces)
        print(f"wrote {args.trace}")
    if args.events:
        obs.write_events_jsonl(args.events, traces)
        print(f"wrote {args.events}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

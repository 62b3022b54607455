"""Exporters: Chrome/Perfetto ``trace_event`` JSON and a JSONL event log.

Two output formats, two clock domains — deliberately:

* :func:`chrome_trace` emits the Chrome trace_event format (load it at
  https://ui.perfetto.dev or chrome://tracing). Timestamps are **wall
  time** (microseconds from the earliest record), because the view is a
  profiler: where did the host actually spend its time. Each span's
  ``args`` carries the sim-clock endpoints, the span tree ids
  (``span_id``/``parent``), and the round/node scope, so the profiler
  (``repro_torch.obs.profile``) reconstructs the exact nesting from the file
  with no interval arithmetic. One traced run = one pid; tid 0 is the
  driver, tid ``n+1`` is node ``n``.
* :func:`events_jsonl` emits the event log ordered by recorder ``seq``
  with **only** simulated-bus timestamps — no wall-clock field exists in
  a line, so two same-seed replays produce byte-identical files (the
  determinism pin in ``tests/test_determinism_smoke.py``).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Sequence, Tuple

from repro_torch.obs.recorder import TraceRecorder

#: One traced run for the multi-run writers: (label, recorder).
TracePair = Tuple[str, TraceRecorder]


def _span_args(s: Any) -> Dict[str, Any]:
    args: Dict[str, Any] = {"span_id": s.span_id, "parent": s.parent,
                            "round": s.round, "node": s.node,
                            "sim_start_ms": s.sim_start,
                            "sim_end_ms": s.sim_end,
                            "sim_dur_ms": s.sim_dur}
    if s.error is not None:
        args["error"] = s.error
    args.update(s.attrs)
    return args


def chrome_trace(traces: Sequence[TracePair]) -> Dict[str, Any]:
    """The trace_event JSON object for one or more traced runs."""
    out: List[Dict[str, Any]] = []
    for pid, (label, rec) in enumerate(traces):
        starts = [s.wall_start for s in rec.spans]
        starts += [e.wall_ts for e in rec.events]
        t0 = min(starts) if starts else 0.0
        tids = {0}
        tids |= {s.node + 1 for s in rec.spans if s.node is not None}
        tids |= {e.node + 1 for e in rec.events if e.node is not None}
        out.append({"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                    "args": {"name": label}})
        for tid in sorted(tids):
            out.append({"ph": "M", "pid": pid, "tid": tid,
                        "name": "thread_name",
                        "args": {"name": "driver" if tid == 0
                                 else f"node {tid - 1}"}})
        for s in sorted(rec.spans, key=lambda s: (s.wall_start, s.span_id)):
            out.append({
                "ph": "X", "pid": pid,
                "tid": 0 if s.node is None else s.node + 1,
                "name": s.name, "cat": s.cat,
                "ts": (s.wall_start - t0) * 1e6,
                "dur": s.wall_dur * 1e6,
                "args": _span_args(s)})
        for e in rec.events:
            out.append({
                "ph": "i", "s": "t", "pid": pid,
                "tid": 0 if e.node is None else e.node + 1,
                "name": e.name, "cat": "event",
                "ts": (e.wall_ts - t0) * 1e6,
                "args": {"seq": e.seq, "round": e.round, "node": e.node,
                         "sim_ms": e.sim_ms, **e.attrs}})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, traces: Sequence[TracePair]) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(traces), f, default=str)


def events_jsonl(traces: Sequence[TracePair]) -> List[str]:
    """Deterministic JSONL lines: ordered by (run, seq), sim clock only.

    Events are ordered by the recorder's emission sequence — which on
    networked paths follows the bus's heap order (arrival time, bus seq),
    never host scheduling — so the byte stream is a pure function of the
    scenario seed.
    """
    lines: List[str] = []
    for label, rec in traces:
        for e in rec.events:
            lines.append(json.dumps(
                {"scenario": label, "seq": e.seq, "event": e.name,
                 "round": e.round, "node": e.node, "sim_ms": e.sim_ms,
                 "attrs": e.attrs},
                sort_keys=True, default=str))
    return lines


def write_events_jsonl(path: str, traces: Sequence[TracePair]) -> None:
    with open(path, "w") as f:
        for line in events_jsonl(traces):
            f.write(line + "\n")

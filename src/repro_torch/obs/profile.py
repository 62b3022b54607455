"""Trace profiling: per-phase latency percentiles and round critical paths.

Operates on the persisted Chrome ``trace_event`` JSON (the output of
``repro_torch.obs.export.chrome_trace`` / ``--trace``), not on live recorders —
so a trace captured in CI can be profiled offline. The span tree is
rebuilt from the ``span_id``/``parent`` ids each span carries in its
``args``; no interval arithmetic.

Two clock domains, selected with ``clock=``:

* ``"wall"`` (default) — host ``perf_counter`` durations. The profiler
  view: where did this run actually spend its time. Varies per replay.
* ``"sim"`` — simulated bus milliseconds. Protocol time: deterministic
  per seed, so ``summarize(..., clock="sim")`` output is pinned
  byte-identical across same-seed replays in the test suite.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.obs.metrics import summarize_values


def load_trace(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _runs(trace: Dict[str, Any]) -> List[Tuple[str, List[Dict[str, Any]]]]:
    """Split a trace into (label, complete-span-events) per pid."""
    labels: Dict[int, str] = {}
    spans: Dict[int, List[Dict[str, Any]]] = {}
    for ev in trace.get("traceEvents", []):
        pid = ev.get("pid", 0)
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            labels[pid] = ev.get("args", {}).get("name", str(pid))
        elif ev.get("ph") == "X":
            spans.setdefault(pid, []).append(ev)
    return [(labels.get(pid, str(pid)), spans[pid]) for pid in sorted(spans)]


def _dur_ms(ev: Dict[str, Any], clock: str) -> Optional[float]:
    if clock == "sim":
        return ev.get("args", {}).get("sim_dur_ms")
    return ev.get("dur", 0.0) / 1000.0


def phase_percentiles(trace: Dict[str, Any],
                      clock: str = "wall") -> Dict[str, Dict[str, float]]:
    """Latency summary (ms) per consensus phase across all runs/rounds."""
    buckets: Dict[str, List[float]] = {}
    for _, spans in _runs(trace):
        for ev in spans:
            if not ev["name"].startswith("phase:"):
                continue
            d = _dur_ms(ev, clock)
            if d is None:
                continue
            name = ev["name"][len("phase:"):]
            # committee-scoped spans (sharded consortium runs) bucket per
            # committee — `commit_reveal@c2` — so the summary drills each
            # committee's critical path; untagged spans keep the plain
            # name, so single-committee summaries are unchanged
            cid = ev.get("args", {}).get("committee")
            if cid is not None:
                name = f"{name}@c{cid}"
            buckets.setdefault(name, []).append(d)
    return {name: summarize_values(vals)
            for name, vals in sorted(buckets.items())}


def _children(spans: List[Dict[str, Any]],
              span_id: int) -> List[Dict[str, Any]]:
    return [ev for ev in spans
            if ev.get("args", {}).get("parent") == span_id]


def critical_paths(trace: Dict[str, Any], clock: str = "wall",
                   top: int = 4) -> List[Dict[str, Any]]:
    """Per-round cost breakdown: which children dominated each round.

    The ``consensus`` child is drilled through — replaced by its own
    children (the ``phase:*`` spans) — so the report attributes round
    time to concrete work (FEL, a specific phase, evaluation), e.g.
    ``round 5: 61% fel, 22% phase:CommitReveal, 9% evaluate``.
    """
    out: List[Dict[str, Any]] = []
    for label, spans in _runs(trace):
        rounds = sorted((ev for ev in spans if ev["name"] == "round"),
                        key=lambda ev: (ev["args"].get("round", -1),
                                        ev["args"]["span_id"]))
        for rnd in rounds:
            total = _dur_ms(rnd, clock)
            if not total:
                continue
            kids: List[Dict[str, Any]] = []
            for child in _children(spans, rnd["args"]["span_id"]):
                if child["name"] == "consensus":
                    inner = _children(spans, child["args"]["span_id"])
                    kids.extend(inner if inner else [child])
                else:
                    kids.append(child)
            parts = []
            accounted = 0.0
            for child in kids:
                d = _dur_ms(child, clock)
                if d is None:
                    continue
                accounted += d
                parts.append((child["name"], d))
            parts.sort(key=lambda p: (-p[1], p[0]))
            other = max(0.0, total - accounted)
            breakdown = [{"name": name, "ms": d, "share": d / total}
                         for name, d in parts[:top]]
            if other / total >= 0.005:
                breakdown.append({"name": "other", "ms": other,
                                  "share": other / total})
            out.append({"scenario": label,
                        "round": rnd["args"].get("round"),
                        "committee": rnd["args"].get("committee"),
                        "total_ms": total,
                        "error": rnd["args"].get("error"),
                        "breakdown": breakdown})
    return out


def format_summary(trace: Dict[str, Any], clock: str = "wall",
                   top: int = 4) -> str:
    """The human-readable report ``repro_torch.obs summarize`` prints.

    With ``clock="sim"`` every number is derived from the deterministic
    bus clock, so this string is byte-identical across same-seed replays.
    """
    lines = [f"# repro_torch.obs summary ({clock} clock)", ""]
    phases = phase_percentiles(trace, clock)
    lines.append("## Per-phase latency (ms)")
    if not phases:
        lines.append("  (no phase spans in trace)")
    for name, s in phases.items():
        lines.append(
            f"  {name:<16} n={s['count']:<4d} p50={s['p50']:.3f} "
            f"p90={s['p90']:.3f} p99={s['p99']:.3f} max={s['max']:.3f}")
    lines.append("")
    lines.append("## Round critical paths")
    paths = critical_paths(trace, clock, top)
    if not paths:
        lines.append("  (no round spans in trace)")
    cur = None
    for p in paths:
        if p["scenario"] != cur:
            cur = p["scenario"]
            lines.append(f"  [{cur}]")
        desc = ", ".join(f"{b['share'] * 100:.1f}% {b['name']}"
                         for b in p["breakdown"])
        suffix = f" (error: {p['error']})" if p.get("error") else ""
        # committee-scoped rounds label their shard; untagged rounds keep
        # the exact pre-shard line (pinned byte-identical per seed)
        com = f" [c{p['committee']}]" if p.get("committee") is not None else ""
        lines.append(f"    round {p['round']}{com}: {p['total_ms']:.3f} ms — "
                     f"{desc}{suffix}")
    return "\n".join(lines) + "\n"


def events_to_trace(jsonl_path: str) -> Dict[str, Any]:
    """``convert``: a JSONL event log → a Perfetto-loadable instant trace.

    The event log carries only sim-clock timestamps, so the converted
    trace places each event at ``sim_ms`` milliseconds (µs timestamps on
    the trace timeline) — a deterministic protocol-time view.
    """
    events: List[Dict[str, Any]] = []
    labels: List[str] = []
    with open(jsonl_path) as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    out: List[Dict[str, Any]] = []
    for e in events:
        if e.get("scenario") not in labels:
            labels.append(e.get("scenario"))
            out.append({"ph": "M", "pid": labels.index(e.get("scenario")),
                        "tid": 0, "name": "process_name",
                        "args": {"name": e.get("scenario")}})
        node = e.get("node")
        out.append({
            "ph": "i", "s": "t",
            "pid": labels.index(e.get("scenario")),
            "tid": 0 if node is None else node + 1,
            "name": e.get("event"), "cat": "event",
            "ts": (e.get("sim_ms") or 0.0) * 1000.0,
            "args": {"seq": e.get("seq"), "round": e.get("round"),
                     "node": node, **(e.get("attrs") or {})}})
    return {"traceEvents": out, "displayTimeUnit": "ms"}

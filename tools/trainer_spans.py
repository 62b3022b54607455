#!/usr/bin/env python3
"""Read the PoFEL trainer's own spans (``repro_torch.obs``) on the card, at
the size of a cell of ``perfbench``.

    python3 tools/trainer_spans.py --workload musicgen-medium.round-2x64 \\
        --seed 2147483701 [--rounds 10] [--pairs 6] [--json FILE]

Sets the cell up as ``perfbench/run.py`` does (the pool, the weights, the
clusters' replicas, the checked rounds that warm every shape), then:

1. ``span_cost``: the host's cost of one span, opened and closed 2,000
   times, with the NullRecorder, a recorder with no device and one with
   the card's readings (two events, two reads of the allocator's
   statistics);
2. ``pairs``: rounds with the recorder off and on (the card's readings
   and the collector's passes), in turns, on the host clock with a
   synchronize after each;
3. ``window``: ``--rounds`` rounds as the benchmark's traced window runs
   them (its host spans around ``local_step`` and ``consensus``, a
   synchronize on both sides) with the recorder on: :func:`per_round`
   of the program's spans beside the harness's ``local_step_ms``,
   ``consensus_ms`` and ``chain_ms``;
4. ``idle``: two rounds under ``torch.profiler`` as the benchmark traces
   them, with a recorder without a device: the device's idle time
   charged to the innermost program span open at each gap's middle
   (:func:`idle_by_program_span`) beside the benchmark's own charge to
   its host spans.

Prints each part as a line and one JSON object last. Needs one CUDA card;
imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
TRAINER = ("forward", "update")


def per_round(spans: Sequence) -> Optional[Dict[str, Optional[float]]]:
    """The trainer's layers a round from its spans (``SpanRecord``s),
    means over the ``pofel_round`` spans: ``forward_ms`` and
    ``update_ms`` (their ``device_ms``), ``backward_ms`` (``local_step``'s
    less its ``forward`` and ``update`` children's), ``gc_ms`` (the host
    time of every ``gc`` span), ``backward_churn_gib`` (the bytes
    ``local_step`` handed out less its children's), and the
    ``local_step``, ``consensus`` and ``pofel_round`` spans' device and
    host times. None without a ``pofel_round``; a device reading None
    where a span lacks it (off the card, or not resolved)."""
    n = sum(1 for s in spans if s.name == "pofel_round")
    if not n:
        return None
    kids: Dict[int, list] = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    steps = [s for s in spans if s.name == "local_step"]
    parts = {name: [c for st in steps for c in kids.get(st.span_id, [])
                    if c.name == name] for name in TRAINER}
    every = steps + parts["forward"] + parts["update"]
    timed = all(s.device_ms is not None for s in every)
    counted = all(s.alloc_bytes is not None for s in every)

    def mean(key, group):
        return sum(getattr(s, key) for s in group) / n

    def named(name):
        return [s for s in spans if s.name == name]

    out = {
        "rounds": n,
        "forward_ms": mean("device_ms", parts["forward"]) if timed else None,
        "update_ms": mean("device_ms", parts["update"]) if timed else None,
        "backward_ms": (mean("device_ms", steps)
                        - mean("device_ms", parts["forward"])
                        - mean("device_ms", parts["update"]))
        if timed else None,
        "gc_ms": mean("wall_dur", named("gc")) * 1e3,
        "backward_churn_gib": (mean("alloc_bytes", steps)
                               - mean("alloc_bytes", parts["forward"])
                               - mean("alloc_bytes", parts["update"]))
        / 2 ** 30 if counted else None,
    }
    for name in ("local_step", "consensus", "pofel_round"):
        group = named(name)
        out[name + "_host_ms"] = mean("wall_dur", group) * 1e3
        out[name + "_device_ms"] = mean("device_ms", group) if all(
            s.device_ms is not None for s in group) else None
    return out


def idle_by_program_span(gaps: Sequence, spans: Sequence, harness=None,
                         n: int = 12) -> List[list]:
    """Idle time (``gaps``: (start, end) on the host clock, seconds)
    summed by the innermost program span (``SpanRecord``s, the same
    clock) open at each gap's middle; where none is, by the harness's
    host span (``harness.innermost``, as ``perfbench.harness.trace
    .idle_by_span`` charges it), or "harness". Most first."""
    starts = np.array([s.wall_start for s in spans], dtype=np.float64)
    ends = starts + np.array([s.wall_dur for s in spans], dtype=np.float64)
    depth = np.array([s.depth for s in spans], dtype=np.int64)
    out: Dict[str, float] = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        inside = np.nonzero((starts <= mid) & (mid < ends))[0]
        if inside.size:
            name = spans[int(inside[np.argmax(depth[inside])])].name
        else:
            name = harness.innermost(mid) if harness else "harness"
        out[name] = out.get(name, 0.0) + (g1 - g0)
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:n]]


def gc_passes(spans: Sequence) -> List[int]:
    """The ``gc`` spans by generation (0, 1, 2)."""
    return [sum(1 for s in spans if s.name == "gc"
                and s.attrs["generation"] == g) for g in range(3)]


def span_cost(obs, torch, dev, n: int = 2000) -> Dict[str, float]:
    """µs of host time a span costs, opened and closed ``n`` times."""
    out = {}
    for label, rec in (("null", obs.NullRecorder()),
                       ("host", obs.TraceRecorder("cost")),
                       ("device", obs.TraceRecorder("cost", device=dev))):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            with rec.span("cost", cat="cost"):
                pass
        out[label + "_us"] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize(dev)
        if rec.enabled:
            rec.resolve()
    return out


def say(tag: str, value) -> None:
    print(f"{tag} " + json.dumps(value), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="musicgen-medium.round-2x64")
    ap.add_argument("--seed", type=int, default=2147483701)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("trainer_spans: no CUDA device; this tool reads the card",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench.harness import cell as cell_mod
    from perfbench.harness import trace
    from perfbench.harness.program import wrapped
    from perfbench.harness.spec import load_cell
    from perfbench.run import power_limit
    from repro_torch import obs
    dev = torch.device("cuda", 0)
    trace.warm_profiler(dev)
    result = {"workload": args.workload, "seed": args.seed,
              "card": power_limit()}
    say("card", result["card"])
    cell = load_cell(args.workload, ROOT)
    t0 = time.perf_counter()
    prog, pool, _ = cell_mod.set_up(cell, args.seed, dev,
                                    cell.config["arch"])
    trace.sync(dev)
    result["setup_s"] = time.perf_counter() - t0
    nxt = iter(range(cell.traffic["check_rounds"], 10 ** 9))

    def round_(spans=None):
        return prog.round(pool[next(nxt) % len(pool)], spans)

    result["span_cost"] = span_cost(obs, torch, dev)
    say("span_cost", result["span_cost"])

    walls = {"off": [], "on": []}
    for i in range(2 * args.pairs):
        on = (i % 2) != (i // 2 % 2)        # off on, on off, off on, ...
        rec = obs.TraceRecorder("pairs", device=dev) if on \
            else obs.NullRecorder()
        trace.sync(dev)
        t0 = time.perf_counter()
        with obs.use_recorder(rec), obs.record_collector(rec):
            round_()
        trace.sync(dev)
        walls["on" if on else "off"].append(
            (time.perf_counter() - t0) * 1e3)
    result["pairs"] = {k: {"median_ms": statistics.median(v), "ms": v}
                       for k, v in walls.items()}
    say("pairs", result["pairs"])

    spans = trace.Spans(dev, sync_each=True)
    rec = obs.TraceRecorder("window", device=dev)
    with wrapped(prog, spans), obs.use_recorder(rec), \
            obs.record_collector(rec):
        for _ in range(args.rounds):
            with spans("round"):
                round_(spans)
    rec.resolve()
    totals = spans.totals()
    window = per_round(rec.spans)
    for name in ("round", "local_step", "consensus", "chain"):
        window["harness_" + name + "_ms"] = \
            totals[name] / spans.count(name) * 1e3
    window["layers_over_local_step"] = (
        window["forward_ms"] + window["backward_ms"] + window["update_ms"]
    ) / window["harness_local_step_ms"]
    window["gc_passes"] = gc_passes(rec.spans)
    # the recorder's cost a round: the spans that read the card, and the
    # collector's, at the host cost ``span_cost`` measured
    cost = result["span_cost"]
    read = sum(1 for s in rec.spans if s.name != "gc") / window["rounds"]
    window["recorder_ms"] = (read * cost["device_us"] + sum(
        window["gc_passes"]) / window["rounds"] * cost["host_us"]) * 1e-3
    window["recorder_share"] = window["recorder_ms"] / \
        window["harness_round_ms"]
    result["window"] = window
    say("window", window)

    host = trace.Spans(dev, sync_each=False)
    box = {}

    def traced():
        rec = box["rec"] = obs.TraceRecorder("profiled")
        with wrapped(prog, host), obs.use_recorder(rec), \
                obs.record_collector(rec):
            for _ in range(2):
                round_(host)

    for _ in range(3):
        host.events.clear()
        _, tr = trace.profile(traced, dev)
        if tr.complete:
            break
    gaps = tr.gaps()
    by_harness = trace.idle_by_span(tr, host, n=100)
    by_program = idle_by_program_span(gaps, box["rec"].spans, host, n=100)
    result["idle"] = {
        "complete": tr.complete, "window_s": tr.window_s,
        "busy_s": tr.busy_s(), "idle_s": sum(b - a for a, b in gaps),
        "by_harness_span": by_harness, "by_program_span": by_program,
        "sum_by_harness": sum(v for _, v in by_harness),
        "sum_by_program": sum(v for _, v in by_program),
        "gc_passes": gc_passes(box["rec"].spans),
        "gc_s": sum(s.wall_dur for s in box["rec"].spans if s.name == "gc")}
    say("idle", result["idle"])
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

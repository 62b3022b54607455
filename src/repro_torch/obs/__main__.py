"""CLI: ``python -m repro_torch.obs summarize|convert``.

``summarize TRACE`` prints per-phase latency percentiles and the
critical path of each round from a Perfetto trace produced by
``python -m repro_torch.sim --trace``. ``--clock sim`` switches every number
to the deterministic simulated-bus clock.

``convert EVENTS.jsonl -o TRACE.json`` turns a JSONL event log
(``--events``) into a Perfetto-loadable instant trace on the sim-clock
timeline.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch.obs.profile import events_to_trace, format_summary, load_trace


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Profile repro_torch traces: summarize | convert")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_sum = sub.add_parser(
        "summarize",
        help="per-phase latency percentiles + per-round critical paths")
    p_sum.add_argument("trace", help="Perfetto trace JSON (from --trace)")
    p_sum.add_argument("--clock", choices=("wall", "sim"), default="wall",
                       help="wall = host time (profiling); "
                            "sim = bus time (deterministic per seed)")
    p_sum.add_argument("--top", type=int, default=4,
                       help="max contributors per round breakdown")

    p_conv = sub.add_parser(
        "convert",
        help="JSONL event log -> Perfetto instant trace (sim timeline)")
    p_conv.add_argument("events", help="JSONL event log (from --events)")
    p_conv.add_argument("-o", "--out", required=True,
                        help="output Perfetto trace JSON path")

    args = parser.parse_args(argv)
    if args.cmd == "summarize":
        sys.stdout.write(
            format_summary(load_trace(args.trace), args.clock, args.top))
    else:
        with open(args.out, "w") as f:
            json.dump(events_to_trace(args.events), f, default=str)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

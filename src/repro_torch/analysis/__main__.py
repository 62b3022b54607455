"""CLI: ``python -m repro_torch.analysis [paths] --format=text|json|github``
(port of ``python -m repro.analysis``).

Exit codes: 0 — no unsuppressed findings (the gate passes); 1 — findings;
2 — configuration error (unreadable path, malformed baseline).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List

from repro_torch.analysis import (ALL_RULES, AnalysisReport, BaselineError,
                            analyze_paths, load_baseline, save_baseline)

DEFAULT_BASELINE = "analysis-baseline.json"


def _fmt_text(report: AnalysisReport) -> str:
    lines: List[str] = []
    for f in report.findings:
        lines.append(f"{f.path}:{f.line}:{f.col + 1}: {f.rule} {f.message}")
    for err in report.errors:
        lines.append(f"error: {err}")
    for e in report.stale_baseline:
        lines.append(f"note: stale baseline entry {e.rule} at {e.path} "
                     f"({e.snippet!r}) matched nothing — delete it")
    lines.append(
        f"{len(report.findings)} finding(s) in {report.files_analyzed} "
        f"file(s) ({len(report.suppressed)} noqa-suppressed, "
        f"{len(report.grandfathered)} baselined)")
    return "\n".join(lines)


def _fmt_github(report: AnalysisReport) -> str:
    """GitHub Actions workflow commands — findings annotate the diff."""
    lines = []
    for f in report.findings:
        msg = f.message.replace("%", "%25").replace("\n", "%0A")
        lines.append(f"::error file={f.path},line={f.line},"
                     f"col={f.col + 1},title={f.rule}::{msg}")
    for err in report.errors:
        lines.append(f"::error::{err}")
    for e in report.stale_baseline:
        lines.append(f"::warning file={e.path},title=stale-baseline::"
                     f"{e.rule} baseline entry matched nothing — delete it")
    lines.append(f"{len(report.findings)} finding(s) "
                 f"({len(report.grandfathered)} baselined)")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Consensus-safety static analysis (RA1xx determinism, "
                    "RA2xx constant-time crypto, RA3xx JAX tracing "
                    "hygiene, RA4xx domain separation)")
    ap.add_argument("paths", nargs="*", default=["src", "tests"],
                    help="files/directories to analyze (default: src tests)")
    ap.add_argument("--format", choices=("text", "json", "github"),
                    default="text")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default: {DEFAULT_BASELINE} "
                         f"at the analysis root, if present)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore any baseline file")
    ap.add_argument("--write-baseline", metavar="FILE",
                    help="write current findings as a baseline (entries "
                         "carry a placeholder justification the loader "
                         "rejects until replaced) and exit 0")
    ap.add_argument("--json-out", metavar="FILE",
                    help="additionally write the full JSON report here "
                         "(the CI artifact)")
    ap.add_argument("--select", action="append", default=None,
                    metavar="RAxxx",
                    help="only report these rules / rule prefixes "
                         "(repeatable, e.g. --select RA1 --select RA402)")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.code}  {rule.name:28s} {rule.summary}")
        return 0

    baseline = []
    if not args.no_baseline and not args.write_baseline:
        path = args.baseline or DEFAULT_BASELINE
        if os.path.exists(path):
            try:
                baseline = load_baseline(path)
            except (BaselineError, json.JSONDecodeError) as e:
                print(f"error: {e}", file=sys.stderr)
                return 2
        elif args.baseline is not None:
            print(f"error: baseline {path} not found", file=sys.stderr)
            return 2

    try:
        report = analyze_paths(args.paths, baseline=baseline,
                               select=args.select)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        save_baseline(args.write_baseline, report.findings)
        print(f"wrote {len(report.findings)} entries to "
              f"{args.write_baseline}; fill in every justification before "
              f"the gate will load it")
        return 0

    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as fh:
            json.dump(report.to_dict(), fh, indent=2)
            fh.write("\n")

    if args.format == "json":
        print(json.dumps(report.to_dict(), indent=2))
    elif args.format == "github":
        print(_fmt_github(report))
    else:
        print(_fmt_text(report))
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())

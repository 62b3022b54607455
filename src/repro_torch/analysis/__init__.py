"""`repro_torch.analysis` — consensus-safety static analysis for the PoFEL
repo, over the JAX package and its PyTorch port alike.

Port of ``repro.analysis``: it gives the reference's findings on every
file outside the port, and holds the port's modules to the rules of their
twins (``repro_torch/core/...`` is scoped as ``repro/core/...``; see
:func:`file_scopes`), with the port's own envelope registry (RA4xx).
The AST-based rule families guard the properties the consensus layer's
correctness rests on (see ANALYSIS.md for the full catalogue and the
workflow):

* **RA1xx determinism** — unseeded/global RNG (numpy's, the stdlib's
  and torch's global generator), wall-clock reads, and
  hash-order set iteration in consensus-path modules. Every honest node
  must compute byte-identical protocol state; arrival-order-dependent
  plagiarism attribution is the canonical bug this family pins.
* **RA2xx constant-time crypto** — short-circuiting ``==`` on
  tags/digests, secret-dependent branches, variable-time arithmetic on
  secret scalars, inside the crypto surface.
* **RA3xx JAX tracing hygiene** — host side effects and Python casts
  inside traced functions, static-argument hygiene, unscoped float64.
* **RA4xx domain separation** — every envelope kind registered in
  ``envelope.KINDS``, no raw-digest ``dsign``, no shared domain tags.
* **RA151 observability** — phase hooks and obs code stay read-only.

Run it (stdlib ``ast`` and ``tokenize``; no JAX):

    python -m repro_torch.analysis src/repro_torch --format=text|json|github

Suppress a single deliberate finding inline with ``# noqa: RA###``;
grandfather legacy ones in ``analysis-baseline.json`` (every entry needs
a justification — see ``repro_torch.analysis.baseline``). Exit code 0 means no
unsuppressed findings: the CI gate.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis.baseline import (BaselineEntry, BaselineError,
                                     apply_baseline, load_baseline,
                                     save_baseline)
from repro_torch.analysis.checkers import (ALL_RULES, consttime, determinism,
                                     domains, obshooks, tracing)
from repro_torch.analysis.core import (FileContext, Finding, Rule, apply_noqa,
                                 collect_files, file_scopes,
                                 noqa_directives)

__all__ = [
    "ALL_RULES", "AnalysisReport", "BaselineEntry", "BaselineError",
    "FileContext", "Finding", "Rule", "analyze_contexts", "analyze_paths",
    "analyze_source", "collect_files", "file_scopes", "load_baseline",
    "save_baseline",
]


@dataclass
class AnalysisReport:
    """Everything one analysis run produced, pre-baseline and post."""

    findings: List[Finding] = field(default_factory=list)       # unsuppressed
    suppressed: List[Finding] = field(default_factory=list)     # # noqa
    grandfathered: List[Finding] = field(default_factory=list)  # baseline
    stale_baseline: List[BaselineEntry] = field(default_factory=list)
    errors: List[str] = field(default_factory=list)             # parse errors
    files_analyzed: int = 0

    @property
    def ok(self) -> bool:
        return not self.findings and not self.errors

    def to_dict(self) -> Dict[str, object]:
        return {
            "ok": self.ok,
            "files_analyzed": self.files_analyzed,
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "grandfathered": [f.to_dict() for f in self.grandfathered],
            "stale_baseline": [e.to_dict() for e in self.stale_baseline],
            "errors": list(self.errors),
        }


def _select(findings, rules: Optional[Sequence[str]]):
    if not rules:
        return list(findings)
    prefixes = tuple(r.upper().rstrip("X") for r in rules)
    return [f for f in findings if f.rule.upper().startswith(prefixes)]


def analyze_contexts(contexts: Sequence[FileContext],
                     baseline: Sequence[BaselineEntry] = (),
                     select: Optional[Sequence[str]] = None,
                     ) -> AnalysisReport:
    """Run every checker over already-parsed file contexts."""
    report = AnalysisReport(files_analyzed=len(contexts))
    registry = domains.registries(contexts)
    raw: List[Finding] = []
    for ctx in contexts:
        per_file: List[Finding] = []
        per_file.extend(determinism.check(ctx))
        per_file.extend(obshooks.check(ctx))
        per_file.extend(consttime.check(ctx))
        per_file.extend(tracing.check(ctx))
        per_file.extend(domains.check_file(
            ctx, registry[domains.package_of(ctx.path)]))
        kept, suppressed = apply_noqa(per_file, noqa_directives(ctx.source))
        raw.extend(kept)
        report.suppressed.extend(suppressed)
    raw = _select(raw, select)
    report.suppressed = _select(report.suppressed, select)
    kept, grandfathered, stale = apply_baseline(raw, baseline)
    report.findings = sorted(kept, key=Finding.sort_key)
    report.grandfathered = sorted(grandfathered, key=Finding.sort_key)
    report.stale_baseline = stale
    report.suppressed.sort(key=Finding.sort_key)
    return report


def analyze_source(source: str,
                   path: str = "src/repro_torch/core/snippet.py",
                   select: Optional[Sequence[str]] = None,
                   ) -> AnalysisReport:
    """Analyze one in-memory snippet as if it lived at ``path`` — the
    path decides which scopes (and so which rules) apply. Fixture tests
    build on this."""
    return analyze_contexts([FileContext.parse(source, path)],
                            select=select)


def analyze_paths(paths: Sequence[str], root: Optional[str] = None,
                  baseline: Sequence[BaselineEntry] = (),
                  select: Optional[Sequence[str]] = None,
                  ) -> AnalysisReport:
    """Analyze every ``.py`` file under ``paths`` (relative to ``root``)."""
    import os
    root = os.path.abspath(root or os.getcwd())
    files = collect_files(paths, root=root)
    contexts: List[FileContext] = []
    errors: List[str] = []
    for full in files:
        rel = os.path.relpath(full, root).replace(os.sep, "/")
        try:
            with open(full, "r", encoding="utf-8") as fh:
                source = fh.read()
            contexts.append(FileContext.parse(source, rel))
        except (SyntaxError, UnicodeDecodeError) as e:
            errors.append(f"{rel}: {e.__class__.__name__}: {e}")
    report = analyze_contexts(contexts, baseline=baseline, select=select)
    report.errors.extend(errors)
    return report

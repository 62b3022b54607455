"""Baseline (grandfathered findings) for `repro_torch.analysis` (port of
``repro.analysis.baseline``, unchanged: it reads the reference's
``analysis-baseline.json``).

Some findings are deliberate: a pure-Python ECDSA signer *is*
variable-time, and the gate must not force a rewrite to land — but every
such exception has to be recorded, justified, and stop matching the
moment the code changes. The baseline file (``analysis-baseline.json`` at
the repo root by default) holds one entry per grandfathered finding:

    {"rule": "RA203", "path": "src/repro/core/crypto/__init__.py",
     "snippet": "s = _inv_mod(k, _N) * (z + r * private_key) % _N",
     "justification": "...why this is acceptable..."}

Matching is by ``(rule, path, snippet)`` — the stripped source line — so
entries survive unrelated line drift but die when the flagged line itself
changes. Every entry MUST carry a non-empty, non-placeholder
``justification`` (the ``save_baseline`` default ``"TODO: justify or
fix"`` is rejected at load time); the CLI refuses a baseline that
doesn't. Unmatched entries are reported as stale
so the file can't silently rot.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, Iterable, List, Sequence, Tuple

from repro_torch.analysis.core import Finding

BASELINE_VERSION = 1


class BaselineError(ValueError):
    """Malformed baseline file (bad shape or missing justification)."""


@dataclass(frozen=True)
class BaselineEntry:
    rule: str
    path: str
    snippet: str
    justification: str
    line: int = 0        # informational only — not used for matching

    def key(self) -> Tuple[str, str, str]:
        return (self.rule.upper(), self.path, self.snippet)

    def to_dict(self) -> Dict[str, object]:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "snippet": self.snippet,
                "justification": self.justification}


def load_baseline(path: str) -> List[BaselineEntry]:
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    if not isinstance(data, dict) or "entries" not in data:
        raise BaselineError(
            f"{path}: baseline must be an object with an 'entries' list")
    entries = []
    for i, raw in enumerate(data["entries"]):
        missing = [k for k in ("rule", "path", "snippet", "justification")
                   if k not in raw]
        if missing:
            raise BaselineError(
                f"{path}: entry {i} is missing {missing}")
        justification = str(raw["justification"]).strip()
        # reject the save_baseline placeholder as hard as an empty string:
        # a freshly regenerated baseline must not pass the gate until a
        # human replaces "TODO: justify or fix" with an actual reason
        if not justification or justification.upper().startswith("TODO"):
            raise BaselineError(
                f"{path}: entry {i} ({raw['rule']} at {raw['path']}) has "
                f"an empty or placeholder justification "
                f"({justification!r}) — every grandfathered finding "
                f"must say why it is acceptable")
        entries.append(BaselineEntry(
            rule=str(raw["rule"]), path=str(raw["path"]),
            snippet=str(raw["snippet"]),
            justification=str(raw["justification"]),
            line=int(raw.get("line", 0))))
    return entries


def save_baseline(path: str, findings: Sequence[Finding],
                  justification: str = "TODO: justify or fix") -> None:
    """Write a baseline grandfathering ``findings``. Fresh entries carry a
    placeholder justification the loader will *reject* until a human
    replaces it — regenerating the baseline can never silence the gate by
    itself."""
    entries = [BaselineEntry(f.rule, f.path, f.snippet, justification,
                             f.line).to_dict()
               for f in sorted(findings, key=Finding.sort_key)]
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"version": BASELINE_VERSION, "entries": entries}, fh,
                  indent=2, sort_keys=False)
        fh.write("\n")


def apply_baseline(findings: Iterable[Finding],
                   entries: Sequence[BaselineEntry]
                   ) -> Tuple[List[Finding], List[Finding],
                              List[BaselineEntry]]:
    """Split findings into (kept, grandfathered) and return the stale
    baseline entries that matched nothing (candidates for deletion)."""
    by_key: Dict[Tuple[str, str, str], BaselineEntry] = {
        e.key(): e for e in entries}
    used = set()
    kept, grandfathered = [], []
    for f in findings:
        key = (f.rule.upper(), f.path, f.snippet)
        if key in by_key:
            used.add(key)
            grandfathered.append(f)
        else:
            kept.append(f)
    stale = [e for e in entries if e.key() not in used]
    return kept, grandfathered, stale

"""The `repro_torch.analysis` engine: findings, rules, path scoping, noqa.

Port of ``repro.analysis.core``. Every checker consumes a parsed
:class:`FileContext` and yields :class:`Finding`s. The engine owns
everything rule-independent:

* collecting ``.py`` files from the CLI's path arguments;
* deciding which *scopes* a file belongs to (consensus-path modules get
  the determinism rules, the crypto surface gets the constant-time
  rules — see :func:`file_scopes`); a file of the port
  (``repro_torch/...``) gets the scopes of its twin in the JAX package
  (``repro/...``), so both packages' consensus code is held to the same
  rules;
* inline suppression (``# noqa: RA201`` on the flagged line, flake8
  semantics: a bare ``# noqa`` silences every rule on that line);
* stable ordering and JSON shapes for the reports.

Baseline matching (grandfathered findings) lives in
``repro_torch.analysis.baseline``; the five rule families live under
``repro_torch.analysis.checkers``.
"""

from __future__ import annotations

import ast
import os
import re
import tokenize
from dataclasses import dataclass, field
from io import StringIO
from pathlib import PurePosixPath
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Findings and rules
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Rule:
    """One checkable bug pattern. ``code`` is the stable id noqa comments
    and baseline entries refer to (RA1xx determinism, RA2xx constant-time
    crypto, RA3xx JAX tracing hygiene, RA4xx domain separation)."""

    code: str           # e.g. "RA101"
    name: str           # short kebab-case slug
    summary: str        # one-line description for --list-rules / docs


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str           # posix-style path, relative to the analysis root
    line: int           # 1-based
    col: int            # 0-based
    message: str
    snippet: str = ""   # the stripped source line (baseline fingerprint)

    def sort_key(self) -> Tuple[str, int, int, str]:
        return (self.path, self.line, self.col, self.rule)

    def to_dict(self) -> Dict[str, object]:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "snippet": self.snippet}


# ---------------------------------------------------------------------------
# File scoping
# ---------------------------------------------------------------------------
# Scope names are coarse path classes the checkers key their rules on:
#
#   consensus  — modules whose outputs feed ordered protocol state
#                (repro/core, repro/blockchain, repro/sim)
#
# A ``repro_torch`` path part counts as ``repro``: the port's modules take
# the scopes of their twins in the JAX package.
#   rng        — everywhere unseeded RNG is a reproducibility bug:
#                consensus scope plus benchmarks/ (every bench must
#                replay from its seed= argument alone)
#   crypto     — the constant-time surface: repro/core/crypto plus the
#                commitment/envelope verify paths (hcds.py, envelope.py,
#                phases.py)
#   obs        — the observability package (repro/obs): hook/recorder code
#                that must stay read-only w.r.t. protocol state (RA15x)
#   src        — first-party package code (not tests, not fixtures)
#   tests      — test files (some rules stay quiet here by design)

_CONSENSUS_PARTS = (("repro", "core"), ("repro", "blockchain"),
                    ("repro", "sim"))
_CRYPTO_FILES = ("hcds.py", "envelope.py", "phases.py")
# the port's package name -> the reference's, for scoping
_PACKAGE_OF = {"repro_torch": "repro"}


def _has_run(parts: Sequence[str], run: Sequence[str]) -> bool:
    n = len(run)
    return any(tuple(parts[i:i + n]) == tuple(run)
               for i in range(len(parts) - n + 1))


def file_scopes(rel_path: str) -> frozenset:
    p = PurePosixPath(rel_path.replace(os.sep, "/"))
    parts = tuple(_PACKAGE_OF.get(part, part) for part in p.parts)
    scopes = set()
    consensus = any(_has_run(parts, run) for run in _CONSENSUS_PARTS)
    if consensus:
        scopes.add("consensus")
        scopes.add("rng")
    if "benchmarks" in parts:
        scopes.add("rng")
    if _has_run(parts, ("repro", "core", "crypto")) or (
            _has_run(parts, ("repro", "core")) and p.name in _CRYPTO_FILES):
        scopes.add("crypto")
    if _has_run(parts, ("repro", "obs")):
        scopes.add("obs")
    if any(part == "tests" for part in parts) or p.name.startswith("test_"):
        scopes.add("tests")
    else:
        scopes.add("src")
    if "repro" in parts:
        # first-party package code (not benchmarks/examples driving it)
        scopes.add("repro")
    return frozenset(scopes)


# ---------------------------------------------------------------------------
# Parsed file context
# ---------------------------------------------------------------------------


@dataclass
class FileContext:
    """Everything a checker needs about one source file."""

    path: str                   # as reported in findings (posix, relative)
    source: str
    tree: ast.Module
    lines: List[str] = field(default_factory=list)
    scopes: frozenset = frozenset()

    @classmethod
    def parse(cls, source: str, path: str) -> "FileContext":
        rel = path.replace(os.sep, "/")
        tree = ast.parse(source, filename=rel)
        return cls(path=rel, source=source, tree=tree,
                   lines=source.splitlines(), scopes=file_scopes(rel))

    def line_at(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Finding(rule=rule, path=self.path, line=line, col=col,
                       message=message, snippet=self.line_at(line).strip())


# ---------------------------------------------------------------------------
# Inline suppression (# noqa: RA###)
# ---------------------------------------------------------------------------

_NOQA_RE = re.compile(
    r"#\s*noqa(?::\s*(?P<codes>RA\d+(?:\s*,\s*RA\d+)*))?", re.IGNORECASE)


def noqa_directives(source: str) -> Dict[int, Optional[frozenset]]:
    """Map line number -> suppressed codes (None = every rule).

    Comments are found with the tokenizer, not a per-line regex, so a
    ``# noqa`` inside a string literal does not suppress anything.
    """
    out: Dict[int, Optional[frozenset]] = {}
    try:
        tokens = tokenize.generate_tokens(StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _NOQA_RE.search(tok.string)
            if not m:
                continue
            codes = m.group("codes")
            if codes is None:
                out[tok.start[0]] = None
            else:
                parsed = frozenset(c.strip().upper()
                                   for c in codes.split(","))
                prev = out.get(tok.start[0], frozenset())
                out[tok.start[0]] = (None if prev is None
                                     else frozenset(prev) | parsed)
    except tokenize.TokenError:
        pass
    return out


def apply_noqa(findings: Iterable[Finding],
               directives: Dict[int, Optional[frozenset]]
               ) -> Tuple[List[Finding], List[Finding]]:
    """Split findings into (kept, suppressed) according to noqa comments."""
    kept, suppressed = [], []
    for f in findings:
        codes = directives.get(f.line, frozenset())
        if codes is None or f.rule.upper() in codes:
            suppressed.append(f)
        else:
            kept.append(f)
    return kept, suppressed


# ---------------------------------------------------------------------------
# File collection
# ---------------------------------------------------------------------------

_SKIP_DIRS = {"__pycache__", ".git", ".hypothesis", ".pytest_cache",
              "node_modules", ".venv", "venv", ".eggs", "build", "dist"}


def collect_files(paths: Sequence[str], root: Optional[str] = None
                  ) -> List[str]:
    """Expand CLI path arguments into a sorted list of ``.py`` files,
    reported relative to ``root`` (default: the current directory)."""
    root = os.path.abspath(root or os.getcwd())
    seen = {}
    for raw in paths:
        p = os.path.abspath(os.path.join(root, raw) if not os.path.isabs(raw)
                            else raw)
        if os.path.isfile(p):
            if p.endswith(".py"):
                seen[os.path.relpath(p, root)] = p
            continue
        if not os.path.isdir(p):
            raise FileNotFoundError(f"no such file or directory: {raw}")
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in _SKIP_DIRS
                                 and not d.startswith("."))
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    full = os.path.join(dirpath, fn)
                    seen[os.path.relpath(full, root)] = full
    return [seen[k] for k in sorted(seen)]


# ---------------------------------------------------------------------------
# AST helpers shared by the checkers
# ---------------------------------------------------------------------------


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(node: ast.Call) -> Optional[str]:
    return dotted_name(node.func)


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def is_literal(node: ast.AST) -> bool:
    """Constant, or a tuple/list of constants — statically known."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return all(is_literal(e) for e in node.elts)
    return False


def walk_functions(tree: ast.Module) -> Iterator[ast.AST]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node

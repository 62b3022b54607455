"""RA4xx — signing-digest domain separation.

Port of ``repro.analysis.checkers.domains`` with one registry a package:
a file of the port (a ``repro_torch`` path part) is held to the
``KINDS`` and ``_DOMAIN`` of ``repro_torch/core/envelope.py``, every
other file to those of ``repro/core/envelope.py``, as the reference
holds it. RA404's "redefined elsewhere" compares within one package, so
the port's envelope, which speaks the reference's wire format, is not a
second definition of the reference's tag.

Every broadcast is a ``SignedEnvelope`` whose signing digest binds
a ``(kind, round, sender)`` header under the ``pofel-envelope-v1`` domain
tag — a commit tag can never verify as a vote. That guarantee is only as
good as the call sites: a new message kind that isn't registered in
``envelope.KINDS``, or a ``dsign`` over a raw hash with no domain header,
silently reopens cross-phase replay.

The checker builds each package's kind registry from its
``core/envelope.py`` in the scanned tree (falling back to the installed
``repro_torch.core.envelope``) and verifies:

RA401  a literal envelope kind at a ``SignedEnvelope(...)`` /
       ``SignedEnvelope.seal(...)`` / ``signing_digest(...)`` call site
       is registered in ``KINDS``.

RA402  the kind expression is a literal at all — a variable kind can't be
       statically tied to the registry (tests that sweep kinds suppress
       with ``# noqa: RA402``).

RA403  first-party ``dsign(...)`` call sites outside the envelope/crypto
       implementation derive their digest from a registered
       domain-separated constructor (``signing_digest`` /
       ``commit_signing_digest`` / ``SignedEnvelope.seal``), not a raw
       ``sha256_digest``.

RA404  registry integrity: no duplicate kinds in ``KINDS``, and no second
       module redefines an envelope ``_DOMAIN`` tag equal to the
       registered one (two message namespaces must never share a domain).
"""

from __future__ import annotations

import ast
import os
from pathlib import PurePosixPath
from typing import Dict, Iterator, Optional, Sequence, Tuple

from repro_torch.analysis.core import (FileContext, Finding, Rule, call_name,
                                 const_str)

RULES = (
    Rule("RA401", "unregistered-envelope-kind",
         "envelope kind literal not registered in envelope.KINDS"),
    Rule("RA402", "non-literal-envelope-kind",
         "envelope kind is not a literal — domain separation can't be "
         "verified statically"),
    Rule("RA403", "undomained-dsign",
         "dsign over a digest not built by a registered domain-separated "
         "constructor"),
    Rule("RA404", "duplicate-domain-tag",
         "two message kinds / modules share one signing-domain tag"),
)

# digest constructors that bind a domain header (the registry's blessing)
_DOMAINED_CONSTRUCTORS = {"signing_digest", "commit_signing_digest"}

_FALLBACK_KINDS = ("commit", "reveal", "vote", "block")

# the packages that each carry an envelope registry
PACKAGES = ("repro", "repro_torch")


def package_of(path: str) -> str:
    """The package whose registry a file is held to: the port's for a path
    with a ``repro_torch`` part, else the reference's."""
    return ("repro_torch" if "repro_torch" in PurePosixPath(path).parts
            else "repro")


class KindRegistry:
    """Envelope kinds + domain tag, parsed out of ``core/envelope.py``."""

    def __init__(self, kinds: Sequence[str], domain: Optional[bytes],
                 source_path: Optional[str]):
        self.kinds = tuple(kinds)
        self.domain = domain
        self.source_path = source_path

    @classmethod
    def build(cls, contexts: Sequence[FileContext],
              package: str) -> "KindRegistry":
        for ctx in contexts:
            base = os.path.basename(ctx.path)
            if base != "envelope.py" or "crypto" not in ctx.scopes \
                    or package_of(ctx.path) != package:
                continue
            kinds, domain = _parse_registry(ctx.tree)
            if kinds:
                return cls(kinds, domain, ctx.path)
        # the scan may cover a subtree that excludes envelope.py — fall
        # back to the installed module so call-site checks still run (the
        # port's registry is the reference's: the same wire format)
        try:
            from repro_torch.core import envelope as _env
            return cls(tuple(_env.KINDS),
                       getattr(_env, "_DOMAIN", None), None)
        except Exception:
            return cls(_FALLBACK_KINDS, None, None)


def registries(contexts: Sequence[FileContext]) -> Dict[str, KindRegistry]:
    """Each package's registry, by :func:`package_of`'s name."""
    return {p: KindRegistry.build(contexts, p) for p in PACKAGES}


def _parse_registry(tree: ast.Module
                    ) -> Tuple[Tuple[str, ...], Optional[bytes]]:
    kinds: Tuple[str, ...] = ()
    domain: Optional[bytes] = None
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            if name == "KINDS" and isinstance(node.value,
                                              (ast.Tuple, ast.List)):
                vals = [const_str(e) for e in node.value.elts]
                if all(v is not None for v in vals):
                    kinds = tuple(vals)
            elif name == "_DOMAIN" and isinstance(node.value, ast.Constant) \
                    and isinstance(node.value.value, bytes):
                domain = node.value.value
    return kinds, domain


def _kind_arg(node: ast.Call) -> Optional[ast.AST]:
    """The kind argument of an envelope-constructing call, or None."""
    for kw in node.keywords:
        if kw.arg == "kind":
            return kw.value
    if node.args:
        return node.args[0]
    return None


def check_file(ctx: FileContext, registry: KindRegistry
               ) -> Iterator[Finding]:
    kinds = set(registry.kinds)
    in_envelope_impl = (registry.source_path is not None
                        and ctx.path == registry.source_path)

    # RA404 (registry integrity, reported at the registry file)
    if in_envelope_impl:
        seen = set()
        for k in registry.kinds:
            if k in seen:
                yield ctx.finding(
                    "RA404", ctx.tree.body[0] if ctx.tree.body else ctx.tree,
                    f"envelope kind {k!r} registered twice in KINDS — two "
                    f"message kinds share one signing domain")
            seen.add(k)

    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        if name is None:
            continue
        tail = name.rsplit(".", 1)[-1]

        if (tail == "seal" and "SignedEnvelope" in name) \
                or name in {"SignedEnvelope", "envelope.SignedEnvelope"} \
                or tail == "signing_digest" and not in_envelope_impl:
            if tail == "commit_signing_digest":
                continue        # fixed-kind constructor, nothing to check
            kind_expr = _kind_arg(node)
            if kind_expr is None:
                continue
            kind = const_str(kind_expr)
            if kind is None:
                yield ctx.finding(
                    "RA402", kind_expr,
                    f"envelope kind passed to `{name}` is not a string "
                    f"literal — cannot statically verify it against the "
                    f"registered KINDS {registry.kinds}")
            elif kind not in kinds:
                yield ctx.finding(
                    "RA401", kind_expr,
                    f"envelope kind {kind!r} is not registered in "
                    f"envelope.KINDS {registry.kinds} — register it (one "
                    f"kind per message namespace) before signing under it")

        elif tail == "dsign" and "repro" in ctx.scopes \
                and "src" in ctx.scopes and "crypto" not in ctx.scopes:
            # RA403: first-party protocol signing outside the
            # envelope/crypto implementation must go through a domained
            # constructor (benchmarks timing the raw primitive, and tests
            # of the primitive itself, are out of scope)
            digest = (node.args[0] if node.args else
                      next((kw.value for kw in node.keywords
                            if kw.arg == "digest"), None))
            if digest is None:
                continue
            if not _is_domained(digest):
                yield ctx.finding(
                    "RA403", node,
                    f"`dsign` over a digest not built by a registered "
                    f"domain-separated constructor "
                    f"({sorted(_DOMAINED_CONSTRUCTORS)}) — raw digests "
                    f"reopen cross-phase replay; seal a SignedEnvelope "
                    f"instead")

    # RA404: a module other than envelope.py defining an envelope _DOMAIN
    if not in_envelope_impl and registry.domain is not None:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id.endswith("_DOMAIN") \
                    and isinstance(node.value, ast.Constant) \
                    and node.value.value == registry.domain:
                yield ctx.finding(
                    "RA404", node,
                    f"domain tag {registry.domain!r} redefined outside "
                    f"the envelope registry — two message namespaces "
                    f"must never share a signing domain")


def _is_domained(digest: ast.AST) -> bool:
    if isinstance(digest, ast.Call):
        name = call_name(digest)
        if name and name.rsplit(".", 1)[-1] in _DOMAINED_CONSTRUCTORS:
            return True
        # method form: env.signing_digest()
        return False
    if isinstance(digest, ast.Name):
        # conservatively accept names that *say* they're signing digests
        return "signing_digest" in digest.id
    return False

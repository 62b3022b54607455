"""RA2xx — constant-time discipline on the crypto surface.

Port of ``repro.analysis.checkers.consttime``, unchanged: the port's
crypto surface (``repro_torch/core/crypto`` and its ``hcds.py``,
``envelope.py`` and ``phases.py``) has the crypto scope too.

FedChain-style attacks on PoFL-descended consensus (PAPERS.md,
arxiv 2308.15095) include timing probes against signature / commitment
verification: a byte-wise ``==`` on a MAC-like value short-circuits at the
first mismatching byte, leaking how much of a forged prefix matched.
These rules apply only inside the crypto scope (``repro/core/crypto``,
``hcds.py``, ``envelope.py``, ``phases.py``):

RA201  variable-time equality on tags/digests. ``==`` / ``!=`` where
       either operand's name marks it as a digest, tag, MAC, or signature
       short-circuits; use ``hmac.compare_digest`` (the repo-local
       helpers ``envelope.digests_equal`` / ``envelope.tags_equal``).

RA202  secret-dependent branching. An ``if``/``while`` whose test reads a
       secret-named value (``private_key``, ``secret``, ``priv``...)
       makes control flow — and therefore time — a function of the
       secret. Validation-at-the-door (raising on an out-of-range key) is
       sometimes deliberate; baseline it with a justification.

RA203  variable-time arithmetic on secret scalars. Python big-int ``*``,
       ``%``, ``pow`` and modular inversion take time dependent on
       operand values; applied to a private key or signing nonce that is
       a timing side channel. Inherent in a pure-Python ECDSA signer —
       deliberate instances belong in the baseline with a justification,
       so the exception is recorded and new ones still fail the gate.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, Optional

from repro_torch.analysis.core import FileContext, Finding, Rule, call_name

RULES = (
    Rule("RA201", "variable-time-compare",
         "==/!= on a tag/digest/MAC-like value short-circuits; use "
         "hmac.compare_digest"),
    Rule("RA202", "secret-dependent-branch",
         "if/while test reads a secret value — control flow (and time) "
         "depends on the secret"),
    Rule("RA203", "variable-time-secret-arith",
         "variable-time arithmetic (* % pow inv) on a secret scalar"),
)

# names that mark a value as MAC-like (compared under RA201). 'hash' is
# deliberately absent: chain head/prev block hashes are public chain
# state compared for fork choice, not authenticators.
_MAC_NAME = re.compile(
    r"(^|_)(digest|digests|tag|tags|mac|hmac|sig|signature|commitment)"
    r"(_|$|s$)", re.IGNORECASE)
_SECRET_NAME = re.compile(
    r"(^|_)(private_key|privkey|priv|secret|seckey|sk)(_|$)",
    re.IGNORECASE)

_VARTIME_BINOPS = (ast.Mult, ast.Mod, ast.Pow, ast.FloorDiv)
# matched against the *tail* of the dotted call name, so `field.inv_mod`
# and `ops.mul_base` hit too
_INV_CALLS = {"inv_mod", "_inv_mod", "pow", "batch_inv"}
_SCALARMUL_CALLS = {"mul_base", "_point_mul", "point_mul_naive",
                    "point_mul_windowed", "strauss_shamir", "multi_scalar",
                    "scalar_mult", "linear_combo", "msm", "msm_jc",
                    "pippenger_msm_jc"}
# Sanctioned sinks for secret scalars: implementations with a uniform
# (secret-independent) operation schedule — the property RA203 exists to
# demand. Key derivation and anything else feeding a secret into one of
# these does not fire; adding a name here requires the implementation to
# keep its fixed double/add schedule (pinned by the differential tests).
_CT_OK_CALLS = {"point_mul_base_ct"}


def _tail_name(node: ast.AST) -> Optional[str]:
    """The rightmost identifier of an expression, looking through calls
    like ``tuple(r.tag)`` / subscripts like ``sig[0]``."""
    if isinstance(node, ast.Call):
        if node.args:
            inner = _tail_name(node.args[0])
            if inner is not None:
                return inner
        return None
    if isinstance(node, ast.Subscript):
        return _tail_name(node.value)
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _is_mac_like(node: ast.AST) -> bool:
    name = _tail_name(node)
    return name is not None and bool(_MAC_NAME.search(name))


def _reads_secret(node: ast.AST) -> Optional[str]:
    for sub in ast.walk(node):
        name = None
        if isinstance(sub, ast.Name):
            name = sub.id
        elif isinstance(sub, ast.Attribute):
            name = sub.attr
        if name is not None and _SECRET_NAME.search(name):
            return name
    return None


def check(ctx: FileContext) -> Iterator[Finding]:
    if "crypto" not in ctx.scopes:
        return
    for node in ast.walk(ctx.tree):
        # RA201 — short-circuiting equality on MAC-like values
        if isinstance(node, ast.Compare):
            operands = [node.left] + list(node.comparators)
            eq_ops = [op for op in node.ops
                      if isinstance(op, (ast.Eq, ast.NotEq))]
            if eq_ops and not _all_trivial(operands):
                if any(_is_mac_like(o) for o in operands):
                    yield ctx.finding(
                        "RA201", node,
                        "==/!= on a tag/digest short-circuits at the first "
                        "differing byte (timing side channel); use "
                        "hmac.compare_digest via envelope.digests_equal / "
                        "envelope.tags_equal")
            # RA202 also covers comparisons used directly in branch tests —
            # handled below at the If/While node.

        # RA202 — secret-dependent control flow
        elif isinstance(node, (ast.If, ast.While)):
            secret = _reads_secret(node.test)
            if secret is not None:
                yield ctx.finding(
                    "RA202", node,
                    f"branch test reads secret `{secret}` — control flow "
                    f"(and execution time) depends on the secret; make the "
                    f"computation branch-free or baseline with a "
                    f"justification if this is validation-at-the-door")

        # RA203 — variable-time arithmetic on secret scalars
        elif isinstance(node, ast.BinOp) and isinstance(node.op,
                                                        _VARTIME_BINOPS):
            for side in (node.left, node.right):
                secret = _reads_secret_shallow(side)
                if secret is not None:
                    yield ctx.finding(
                        "RA203", node,
                        f"`{_op_sym(node.op)}` on secret `{secret}` is "
                        f"variable-time in Python big-int arithmetic — a "
                        f"timing side channel on the signing path; "
                        f"deliberate instances belong in the baseline")
                    break
        elif isinstance(node, ast.Call):
            name = call_name(node)
            tail = name.rsplit(".", 1)[-1] if name else None
            if tail in _CT_OK_CALLS:
                continue
            if tail in _INV_CALLS or tail in _SCALARMUL_CALLS:
                kind = ("modular inversion" if tail in _INV_CALLS
                        else "scalar multiplication")
                for arg in node.args:
                    secret = _reads_secret_shallow(arg)
                    if secret is not None:
                        yield ctx.finding(
                            "RA203", node,
                            f"variable-time {kind} of secret `{secret}` — "
                            f"execution time depends on the secret's bit "
                            f"pattern")
                        break


def _reads_secret_shallow(node: ast.AST) -> Optional[str]:
    """Like :func:`_reads_secret` but does not descend into nested calls,
    so ``f(x) * g(private_key_len)`` style indirection doesn't over-fire —
    only direct Name/Attribute operands count."""
    if isinstance(node, ast.Name) and _SECRET_NAME.search(node.id):
        return node.id
    if isinstance(node, ast.Attribute) and _SECRET_NAME.search(node.attr):
        return node.attr
    return None


def _all_trivial(operands) -> bool:
    """Comparisons against None / small int literals are structural checks
    (e.g. `sig is None`, `len(tag) == 65` guards), not byte comparisons."""
    def trivial(o):
        return isinstance(o, ast.Constant) and (
            o.value is None or isinstance(o.value, (bool, int)))
    non_name = [o for o in operands if not trivial(o)]
    return len(non_name) < 2


def _op_sym(op: ast.operator) -> str:
    return {ast.Mult: "*", ast.Mod: "%", ast.Pow: "**",
            ast.FloorDiv: "//"}[type(op)]

"""RA15x — observability hooks must be read-only.

Port of ``repro.analysis.checkers.obshooks``: the same rule over both
packages (``repro/obs`` and ``repro_torch/obs`` share the obs scope).

The ``repro.obs`` tracer observes consensus through two seams: phase
hooks registered with ``consensus.add_phase_hook`` (handed the live
``RoundContext``) and recorder calls sprinkled through the network,
crypto, and recovery layers (handed ``SimEnv``/network objects). A hook
that *mutates* that state is not an observer any more — it changes
protocol behaviour exactly when tracing is on, which is the worst
possible Heisenbug: deterministic replays diverge depending on whether
someone was watching.

RA151  protocol-state mutation in an observability hook. Flags, inside
       (a) any function in the ``repro/obs`` package that takes a
       context/env parameter, and (b) any function or lambda registered
       via ``add_phase_hook(...)`` anywhere in first-party code:

       * assignments/deletions through the context parameter
         (``ctx.rejected[i] = ...``, ``ctx.round += 1``,
         ``del env.events[0]``), and
       * calls to known mutator methods on state reached through it
         (``ctx.rejected.clear()``, ``ctx.env.note(...)``,
         ``env.network.force_down(...)``).

       Reading (including ``ctx.env.network.now``) is the hooks' job and
       is never flagged.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set

from repro_torch.analysis.core import FileContext, Finding, Rule

RULES = (
    Rule("RA151", "mutating-obs-hook",
         "an observability hook (phase hook / repro.obs code) mutates "
         "RoundContext / SimEnv protocol state; hooks must be read-only"),
)

#: parameter names that denote observed protocol state
_CTX_PARAM_NAMES = {"ctx", "env", "context", "sim_env", "round_ctx"}

#: method names that mutate their receiver (or, for the env/network ones,
#: the protocol state behind it) — calling any of these on state reached
#: through a context parameter is a mutation
_MUTATOR_METHODS = {
    "append", "add", "clear", "update", "pop", "popitem", "setdefault",
    "remove", "discard", "extend", "insert", "sort", "reverse",
    # SimEnv / SimNetwork / contract state transitions
    "note", "submit", "force_down", "execute_crash", "drop_round",
    "begin_round", "end_round", "bind", "finalize",
}


def _root_name(node: ast.AST) -> Optional[str]:
    """The base Name of an attribute/subscript chain (``ctx`` for
    ``ctx.env.events[0]``), else None."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def _func_params(func: ast.AST) -> List[str]:
    a = func.args
    names = [p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)]
    if a.vararg:
        names.append(a.vararg.arg)
    return [n for n in names if n != "self"]


def _suspect_params(func: ast.AST, registered: bool) -> Set[str]:
    """Which of ``func``'s parameters carry observed protocol state.

    For a registered phase hook the calling convention is
    ``fn(phase_name, ctx)`` — everything past the first parameter is the
    context. For obs-package functions, only conventionally-named
    parameters count (a recorder method's ``value`` argument is not
    protocol state)."""
    params = _func_params(func)
    suspects = {p for p in params if p in _CTX_PARAM_NAMES}
    if registered and len(params) >= 2:
        suspects.update(params[1:])
    return suspects


def _mutations(func: ast.AST, suspects: Set[str],
               ctx: FileContext) -> Iterator[Finding]:
    if not suspects:
        return
    for node in ast.walk(func):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, (ast.Attribute, ast.Subscript)) \
                        and _root_name(t) in suspects:
                    yield ctx.finding(
                        "RA151", t,
                        f"observability hook writes through its context "
                        f"parameter `{_root_name(t)}`; hooks observe "
                        f"protocol state, they never mutate it")
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, (ast.Attribute, ast.Subscript)) \
                        and _root_name(t) in suspects:
                    yield ctx.finding(
                        "RA151", t,
                        f"observability hook deletes state through its "
                        f"context parameter `{_root_name(t)}`")
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _MUTATOR_METHODS \
                and _root_name(node.func.value) in suspects:
            yield ctx.finding(
                "RA151", node,
                f"observability hook calls mutator "
                f"`.{node.func.attr}()` on state reached through "
                f"`{_root_name(node.func.value)}`; hooks must be "
                f"read-only with respect to protocol state")


def _registered_hooks(tree: ast.Module) -> Iterator[ast.AST]:
    """Function defs and lambdas passed to ``add_phase_hook`` calls.

    Inline lambdas are yielded directly; a Name argument is resolved
    against the module's function defs (the common registration idiom)."""
    defs = {n.name: n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    seen: Set[int] = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_phase_hook"):
            continue
        candidates = list(node.args[1:2])
        candidates += [kw.value for kw in node.keywords if kw.arg == "fn"]
        for arg in candidates:
            fn: Optional[ast.AST] = None
            if isinstance(arg, ast.Lambda):
                fn = arg
            elif isinstance(arg, ast.Name) and arg.id in defs:
                fn = defs[arg.id]
            if fn is not None and id(fn) not in seen:
                seen.add(id(fn))
                yield fn


def check(ctx: FileContext) -> Iterator[Finding]:
    scopes = ctx.scopes
    if "tests" in scopes:
        return
    if "obs" in scopes:
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                yield from _mutations(node, _suspect_params(node, False),
                                      ctx)
    if "src" in scopes:
        for fn in _registered_hooks(ctx.tree):
            yield from _mutations(fn, _suspect_params(fn, True), ctx)

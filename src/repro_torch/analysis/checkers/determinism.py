"""RA1xx — determinism of consensus-path computations.

Port of ``repro.analysis.checkers.determinism``; RA101 also covers
torch's global generator.

PoFEL's safety argument needs every honest node to compute byte-identical
protocol state: commitment precedence, BTSV tallies, and leader election
are all replicated deterministic computations. Three bug classes break
that silently:

RA101  global-state / unseeded RNG. ``random.random()`` and the legacy
       ``np.random.*`` module functions draw from interpreter-global
       state, so two nodes (or two runs of one bench) diverge. Everything
       randomized must flow from an explicit seeded generator
       (``np.random.default_rng(seed)`` / ``jax.random.key(seed)``).
       Scope: consensus modules *and* ``benchmarks/`` — a bench must
       replay from its ``seed=`` argument alone.

RA102  wall-clock reads. ``time.time()`` (or ``datetime.now()``) inside a
       consensus module makes protocol state depend on when a node runs,
       not what it received. Simulated time (``SimNetwork.now``) or round
       counters are the deterministic substitutes. (``time.perf_counter``
       is allowed — measuring a duration for a report is not protocol
       state.)

RA103  hash-order iteration. Iterating a ``set`` yields an order that
       depends on insertion history and, for str-keyed data, on the
       per-process hash seed — feeding such an order into commit records,
       tally inputs, or ledger ops is exactly the bug class of
       arrival-order-dependent plagiarism attribution. Wrap the
       iteration in ``sorted(...)`` or iterate a canonically-ordered
       structure. Plain ``dict`` iteration is insertion-ordered and is
       *not* flagged — but the insertion order must itself be canonical,
       which RA103 enforces at the points where sets leak into it.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set

from repro_torch.analysis.core import (FileContext, Finding, Rule, call_name,
                                 dotted_name)

RULES = (
    Rule("RA101", "unseeded-global-rng",
         "global-state RNG (random.* / np.random.* / torch's global "
         "generator) in a consensus or benchmark module; use an explicit "
         "seeded Generator"),
    Rule("RA102", "wall-clock-read",
         "wall-clock read (time.time / datetime.now) in a consensus "
         "module; protocol state must not depend on host time"),
    Rule("RA103", "set-iteration-order",
         "iteration over a set feeds ordered state in a consensus "
         "module; wrap in sorted(...) for a canonical order"),
)

# np.random attributes that are fine: explicitly-seeded constructors.
_NP_RANDOM_OK = {"default_rng", "Generator", "SeedSequence", "PCG64",
                 "Philox", "MT19937", "BitGenerator", "RandomState"}
# RandomState is seedable but legacy; flag the *module-level* fns only.

# torch draws from its global generator unless given ``generator=``
_TORCH_DRAWS = {"torch.rand", "torch.randn", "torch.randint",
                "torch.randperm", "torch.bernoulli", "torch.multinomial",
                "torch.normal"}
_TORCH_INPLACE_DRAWS = {"uniform_", "normal_", "bernoulli_", "random_"}
# ...and these reseed it, for every caller in the process
_TORCH_GLOBAL_SEED = {"torch.manual_seed", "torch.seed"}

_WALL_CLOCK = {"time.time", "time.time_ns", "datetime.now",
               "datetime.utcnow", "datetime.datetime.now",
               "datetime.datetime.utcnow", "time.localtime", "time.gmtime"}


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        name = call_name(node)
        if name in {"set", "frozenset"}:
            return True
        # set(...)-returning chains: set(a) | set(b), a_set.union(b) are
        # out of reach without type inference — the locals tracking below
        # catches the common single-assignment case.
    if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.BitOr,
                                                            ast.BitAnd,
                                                            ast.Sub)):
        return _is_set_expr(node.left) or _is_set_expr(node.right)
    return False


def _set_locals(func: ast.AST) -> Set[str]:
    """Names assigned from set-typed expressions anywhere in ``func`` and
    never reassigned from anything else (single coarse pass)."""
    set_names: Set[str] = set()
    other_names: Set[str] = set()
    for node in ast.walk(func):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            target = node.targets[0].id
            (set_names if _is_set_expr(node.value)
             else other_names).add(target)
        elif isinstance(node, ast.AnnAssign) and node.value is not None \
                and isinstance(node.target, ast.Name):
            (set_names if _is_set_expr(node.value)
             else other_names).add(node.target.id)
    return set_names - other_names


def check(ctx: FileContext) -> Iterator[Finding]:
    scopes = ctx.scopes
    rng_scope = "rng" in scopes
    consensus = "consensus" in scopes
    if not (rng_scope or consensus):
        return

    # module-level `import random` => bare random.* calls are the stdlib
    stdlib_random = any(
        isinstance(n, ast.Import) and any(a.name == "random" and
                                          (a.asname or a.name) == "random"
                                          for a in n.names)
        for n in ast.walk(ctx.tree))
    from_random: Set[str] = set()
    for n in ast.walk(ctx.tree):
        if isinstance(n, ast.ImportFrom) and n.module == "random":
            from_random.update(a.asname or a.name for a in n.names)

    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        if name is None:
            # an in-place draw on an expression: ``torch.empty(3).normal_()``
            if rng_scope:
                yield from _check_torch_rng(ctx, node, None)
            continue

        if rng_scope:
            if stdlib_random and name.startswith("random.") \
                    and name.count(".") == 1:
                yield ctx.finding(
                    "RA101", node,
                    f"`{name}()` uses interpreter-global RNG state; draw "
                    f"from an explicit `np.random.default_rng(seed)` (or "
                    f"`random.Random(seed)`) so the run replays from its "
                    f"seed alone")
            elif name in from_random:
                yield ctx.finding(
                    "RA101", node,
                    f"`{name}()` (from random import) uses global RNG "
                    f"state; use an explicit seeded generator")
            else:
                for prefix in ("np.random.", "numpy.random.",
                               "jnp.random."):
                    if name.startswith(prefix):
                        attr = name[len(prefix):].split(".")[0]
                        if attr not in _NP_RANDOM_OK:
                            yield ctx.finding(
                                "RA101", node,
                                f"`{name}()` draws from numpy's global "
                                f"RNG; use `np.random.default_rng(seed)`")
                        break
                else:
                    yield from _check_torch_rng(ctx, node, name)

        if consensus and name in _WALL_CLOCK:
            yield ctx.finding(
                "RA102", node,
                f"`{name}()` reads the wall clock inside a consensus-path "
                f"module; use simulated time / round counters "
                f"(`time.perf_counter` is fine for duration reports)")

    if consensus:
        yield from _check_set_iteration(ctx)


def _check_torch_rng(ctx: FileContext, node: ast.Call,
                     name: Optional[str]) -> Iterator[Finding]:
    """RA101's torch forms: a draw without ``generator=`` from the global
    generator, or a reseed of it. ``name`` is the call's dotted name, or
    None where the receiver is not a name chain."""
    if name in _TORCH_GLOBAL_SEED:
        yield ctx.finding(
            "RA101", node,
            f"`{name}()` reseeds torch's process-global generator; seed an "
            f"explicit `torch.Generator().manual_seed(seed)` and pass it as "
            f"`generator=`")
        return
    draw = name in _TORCH_DRAWS or (
        isinstance(node.func, ast.Attribute)
        and node.func.attr in _TORCH_INPLACE_DRAWS)
    if draw and not any(kw.arg == "generator" for kw in node.keywords):
        what = name or f"….{node.func.attr}"
        yield ctx.finding(
            "RA101", node,
            f"`{what}()` draws from torch's global generator; pass "
            f"`generator=` an explicit seeded `torch.Generator`")


def _iter_targets(func: ast.AST) -> Iterator[ast.AST]:
    """Every expression ``func`` iterates: for-loops, comprehensions, and
    order-materializing conversions (list/tuple/sorted-less enumerate)."""
    for node in ast.walk(func):
        if isinstance(node, ast.For):
            yield node.iter
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            for gen in node.generators:
                yield gen.iter
        elif isinstance(node, ast.Call):
            name = call_name(node)
            if name in {"list", "tuple", "enumerate"} and node.args:
                yield node.args[0]


def _check_set_iteration(ctx: FileContext) -> Iterator[Finding]:
    funcs: List[ast.AST] = [ctx.tree]
    funcs += [n for n in ast.walk(ctx.tree)
              if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    seen: Set[int] = set()
    for func in funcs:
        local_sets = _set_locals(func) if func is not ctx.tree else set()
        for target in _iter_targets(func):
            if id(target) in seen:
                continue
            flagged = _is_set_expr(target) or (
                isinstance(target, ast.Name) and target.id in local_sets)
            if flagged:
                seen.add(id(target))
                what = (f"set `{target.id}`" if isinstance(target, ast.Name)
                        else "a set expression")
                yield ctx.finding(
                    "RA103", target,
                    f"iterating {what} yields hash/insertion order, which "
                    f"must not feed ordered protocol state (commit "
                    f"records, tallies, ledger ops); wrap in `sorted(...)`")

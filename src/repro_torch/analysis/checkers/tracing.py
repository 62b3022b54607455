"""RA3xx — JAX tracing hygiene.

Port of ``repro.analysis.checkers.tracing``, with the reference's rules
as they are, so the port's analyzer reports what the reference's does on
JAX files. The rules read JAX's tracing APIs and find nothing in torch
code.

The FEL engine compiles whole rounds (`fl.batched_fel`), the crypto limb
backend jits the RLC batch equation, and the shape-bucketing caches key
compiled programs on static arguments. Tracing-hostile Python inside any
of those silently recompiles, diverges between traced and eager runs, or
crashes at trace time:

RA301  host side effects inside a traced function. ``print`` runs at
       trace time (once per compilation, not per call); mutating a
       closure/global object from inside ``jit``/``vmap``/``scan`` bodies
       bakes trace-time state into the compiled program.

RA302  Python casts on tracers. ``float(x)`` / ``int(x)`` / ``bool(x)``
       (and ``np.asarray``/``.item()``) force concretization — a
       ``TracerError`` at best, a silent constant-fold at worst.

RA303  static-argument hygiene. ``static_argnames``/``static_argnums``
       given as non-literal expressions defeat review of what keys the
       jit cache; jit-decorated functions with mutable default arguments
       hash-fail (or worse, alias) when treated static.

RA304  unscoped float64. The limb crypto backend relies on *scoped*
       ``jax.experimental.enable_x64`` contexts; a module-level
       ``jax.config.update("jax_enable_x64", ...)`` flips the dtype of
       every array in the process (breaking the f32 FEL engine), and
       ``jnp.float64`` outside such a scope silently downcasts.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set

from repro_torch.analysis.core import (FileContext, Finding, Rule, call_name,
                                 const_str, is_literal)

RULES = (
    Rule("RA301", "traced-side-effect",
         "host side effect (print / closure mutation) inside a "
         "jit/vmap/scan-traced function"),
    Rule("RA302", "tracer-concretization",
         "float()/int()/bool()/np.asarray() on a traced value forces "
         "concretization inside a traced function"),
    Rule("RA303", "static-arg-hygiene",
         "non-literal static_argnames/static_argnums, or a mutable "
         "default argument on a jitted function"),
    Rule("RA304", "unscoped-float64",
         "process-global jax_enable_x64 flip or jnp.float64 outside a "
         "scoped enable_x64 context"),
)

_TRACE_WRAPPERS = {"jit", "vmap", "pmap", "jax.jit", "jax.vmap", "jax.pmap",
                   "checkpoint", "jax.checkpoint", "jax.remat"}
_SCAN_CALLS = {"lax.scan", "jax.lax.scan", "scan", "lax.fori_loop",
               "jax.lax.fori_loop", "lax.while_loop", "jax.lax.while_loop"}
_CAST_CALLS = {"float", "int", "bool", "complex"}
_HOST_ARRAY_CALLS = {"np.asarray", "np.array", "numpy.asarray",
                     "numpy.array"}
_MUTATORS = {"append", "extend", "update", "add", "insert", "pop",
             "setdefault", "remove", "discard", "clear"}


def _decorator_traces(dec: ast.AST) -> bool:
    name = call_name(dec) if isinstance(dec, ast.Call) else None
    if isinstance(dec, (ast.Name, ast.Attribute)):
        dn = call_name(ast.Call(func=dec, args=[], keywords=[]))
        return dn in _TRACE_WRAPPERS
    if name in _TRACE_WRAPPERS:
        return True
    # functools.partial(jax.jit, ...) / partial(jit, ...)
    if name in {"partial", "functools.partial"} and isinstance(dec, ast.Call) \
            and dec.args:
        inner = dec.args[0]
        if isinstance(inner, (ast.Name, ast.Attribute)):
            return (call_name(ast.Call(func=inner, args=[], keywords=[]))
                    in _TRACE_WRAPPERS)
    return False


def _traced_functions(tree: ast.Module) -> List[ast.AST]:
    """FunctionDefs that are traced: decorated by jit/vmap/partial(jit),
    wrapped via `name = jax.jit(fn)`, or passed as a scan/loop body."""
    by_name = {}
    funcs = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            by_name.setdefault(node.name, node)
            if any(_decorator_traces(d) for d in node.decorator_list):
                funcs.append(node)
    wrapped: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = call_name(node)
            if name in _TRACE_WRAPPERS and node.args and isinstance(
                    node.args[0], ast.Name):
                wrapped.add(node.args[0].id)
            elif name in _SCAN_CALLS and node.args and isinstance(
                    node.args[0], ast.Name):
                wrapped.add(node.args[0].id)
    for fname in wrapped:
        fn = by_name.get(fname)
        if fn is not None and fn not in funcs:
            funcs.append(fn)
    return funcs


def _local_names(func: ast.AST) -> Set[str]:
    names: Set[str] = set()
    args = func.args
    for a in (args.posonlyargs + args.args + args.kwonlyargs
              + ([args.vararg] if args.vararg else [])
              + ([args.kwarg] if args.kwarg else [])):
        names.add(a.arg)
    for node in ast.walk(func):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                for sub in ast.walk(t):
                    if isinstance(sub, ast.Name):
                        names.add(sub.id)
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            if isinstance(node.target, ast.Name):
                names.add(node.target.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, (ast.For,)):
            for sub in ast.walk(node.target):
                if isinstance(sub, ast.Name):
                    names.add(sub.id)
        elif isinstance(node, ast.comprehension):
            for sub in ast.walk(node.target):
                if isinstance(sub, ast.Name):
                    names.add(sub.id)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if item.optional_vars is not None:
                    for sub in ast.walk(item.optional_vars):
                        if isinstance(sub, ast.Name):
                            names.add(sub.id)
    return names


def check(ctx: FileContext) -> Iterator[Finding]:
    tree = ctx.tree
    traced = _traced_functions(tree)

    for func in traced:
        locals_ = _local_names(func)
        for node in ast.walk(func):
            if node is func:
                continue
            if isinstance(node, ast.Call):
                name = call_name(node)
                if name == "print":
                    yield ctx.finding(
                        "RA301", node,
                        f"`print` inside traced `{func.name}` runs at "
                        f"trace time, once per compilation — use "
                        f"`jax.debug.print` or hoist out of the jit")
                elif name in _CAST_CALLS and node.args and not is_literal(
                        node.args[0]):
                    yield ctx.finding(
                        "RA302", node,
                        f"`{name}()` inside traced `{func.name}` "
                        f"concretizes a tracer (TracerError or silent "
                        f"constant-fold); keep values as arrays or mark "
                        f"the argument static")
                elif name in _HOST_ARRAY_CALLS and node.args:
                    yield ctx.finding(
                        "RA302", node,
                        f"`{name}()` inside traced `{func.name}` pulls "
                        f"the value to host — use `jnp.asarray` or keep "
                        f"it on device")
                elif isinstance(node.func, ast.Attribute) \
                        and node.func.attr in _MUTATORS:
                    base = node.func.value
                    root = base
                    while isinstance(root, (ast.Attribute, ast.Subscript)):
                        root = root.value
                    if isinstance(root, ast.Name) and root.id not in locals_:
                        yield ctx.finding(
                            "RA301", node,
                            f"`.{node.func.attr}()` mutates closure/global "
                            f"`{root.id}` inside traced `{func.name}` — "
                            f"trace-time state leaks into the compiled "
                            f"program")
            elif isinstance(node, (ast.Global, ast.Nonlocal)):
                yield ctx.finding(
                    "RA301", node,
                    f"`{'global' if isinstance(node, ast.Global) else 'nonlocal'}`"
                    f" declaration inside traced `{func.name}` — Python-"
                    f"side mutation does not trace")
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, ast.Subscript):
                        root = t.value
                        while isinstance(root, (ast.Attribute,
                                                ast.Subscript)):
                            root = root.value
                        if isinstance(root, ast.Name) \
                                and root.id not in locals_:
                            yield ctx.finding(
                                "RA301", t,
                                f"subscript assignment to closure/global "
                                f"`{root.id}` inside traced "
                                f"`{func.name}` is a host side effect")

    # RA303 — static_arg hygiene on every jit call / decorator
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = call_name(node)
            target = None
            if name in {"jit", "jax.jit"}:
                target = node
            elif name in {"partial", "functools.partial"} and node.args:
                inner = node.args[0]
                if isinstance(inner, (ast.Name, ast.Attribute)) and \
                        call_name(ast.Call(func=inner, args=[],
                                           keywords=[])) in {"jit",
                                                             "jax.jit"}:
                    target = node
            if target is not None:
                for kw in target.keywords:
                    if kw.arg in {"static_argnames", "static_argnums"} \
                            and not is_literal(kw.value):
                        yield ctx.finding(
                            "RA303", kw.value,
                            f"`{kw.arg}` is not a literal — what keys the "
                            f"jit cache can't be reviewed statically and "
                            f"may vary per call site")

    for func in traced:
        for default in (func.args.defaults + func.args.kw_defaults):
            if default is not None and isinstance(default, (ast.Dict,
                                                            ast.List,
                                                            ast.Set)):
                yield ctx.finding(
                    "RA303", default,
                    f"mutable default argument on jitted `{func.name}` — "
                    f"unhashable if static, shared trace-time state if "
                    f"not")

    # RA304 — unscoped float64 / global x64 flips
    yield from _check_x64(ctx)


def _check_x64(ctx: FileContext) -> Iterator[Finding]:
    # inside `with enable_x64():` bodies float64 is deliberate
    scoped_lines: Set[int] = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                cexpr = item.context_expr
                nm = (call_name(cexpr) if isinstance(cexpr, ast.Call)
                      else None)
                if nm and nm.rsplit(".", 1)[-1] == "enable_x64":
                    end = getattr(node, "end_lineno", node.lineno)
                    scoped_lines.update(range(node.lineno, end + 1))

    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call):
            name = call_name(node)
            if name and name.rsplit(".", 1)[-1] == "update" and node.args:
                key = const_str(node.args[0])
                if key == "jax_enable_x64":
                    yield ctx.finding(
                        "RA304", node,
                        "process-global `jax_enable_x64` flip — every "
                        "array in the process changes dtype (the f32 FEL "
                        "engine breaks); use the scoped "
                        "`jax.experimental.enable_x64()` context instead")
        elif isinstance(node, ast.Attribute) and node.attr == "float64":
            base = call_name(ast.Call(func=node, args=[], keywords=[]))
            if base and base.split(".")[0] in {"jnp", "jax"} \
                    and node.lineno not in scoped_lines:
                yield ctx.finding(
                    "RA304", node,
                    "`jnp.float64` outside a scoped `enable_x64()` "
                    "context silently produces float32 arrays; scope it "
                    "or use explicit f32")

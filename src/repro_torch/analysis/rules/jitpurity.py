"""EDK1xx — jit-purity rules for the array-program layer.

Scoped to the code that runs under a JAX trace in the reference, at its
path in the port (``repro_torch/kernels`` and the sweep engine).  The
port calls no tracing entry point, so over its tree these rules find
nothing; they stay so that the catalog equals the reference's.  A
*traced function* is one
decorated with / passed by name (directly or through
``functools.partial``) to a tracing entry point (``jax.jit``, ``vmap``,
``lax.scan``, ``pl.pallas_call``, ...).  Nested functions are part of
the same trace and are covered by walking the outermost root.

* **EDK101** — side effects under trace: mutating a closure or global
  (assignment / mutating method call whose base is not bound inside the
  traced scope), ``global``/``nonlocal``, bare ``print``.  Pallas
  ``ref[...] = ...`` stores hit refs that are *parameters* of the
  kernel, which count as locals — the idiomatic kernel stays clean.
* **EDK102** — tracer-to-host coercions: ``float()/int()/bool()`` on a
  non-constant, ``.item()/.tolist()``, and host-``numpy`` calls inside a
  traced function; each forces a concretization error or a silent
  trace-time constant.
* **EDK103** — data-dependent Python control flow: ``if``/``while``/
  conditional expressions whose test reads a value derived from the
  traced function's *arguments*.  Branches on static closure config
  (e.g. ``if scan_backend == "pallas"``) are fine; so are ``is None``
  checks and trace-static attributes (``.shape``/``.ndim``/``.dtype``/
  ``.size``, ``len()``, ``isinstance()``).
* **EDK104** — ``float64`` requests outside the x64 guard
  (``jnp.float64`` / ``astype("float64")`` / ``dtype="float64"`` in jax
  calls): without ``jax.experimental.enable_x64`` (or the
  ``jax_enable_x64`` config flag) jax silently truncates to float32 and
  the <2% cross-engine figures drift.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set

from ..astutil import (FUNCTION_NODES, attach_parents, bound_names,
                       call_name, dotted_name, parent, traced_functions)
from ..engine import FileContext, Finding, Rule, register

_SCOPES = ("repro_torch/kernels", "repro_torch/sim/sweep.py")

_MUTATORS = {"append", "extend", "insert", "add", "update", "pop",
             "popitem", "remove", "discard", "clear", "setdefault",
             "write", "writelines", "__setitem__"}


def _root_name(node: ast.AST) -> Optional[str]:
    """Leftmost Name of a target/base chain: ``a.b[c].d`` -> ``a``."""
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Starred)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


@register
class SideEffectsUnderTrace(Rule):
    id = "EDK101"
    severity = "error"
    summary = ("side effect inside a jit-traced function: closure/global "
               "mutation, global/nonlocal, or print")
    scopes = _SCOPES

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for fn in traced_functions(ctx.tree):
            local = bound_names(fn)
            for node in ast.walk(fn):
                if isinstance(node, (ast.Global, ast.Nonlocal)):
                    out.append(ctx.finding(
                        self, node,
                        f"{type(node).__name__.lower()} inside traced "
                        f"'{fn.name}' mutates state outside the trace"))
                elif isinstance(node, (ast.Assign, ast.AugAssign)):
                    targets = (node.targets
                               if isinstance(node, ast.Assign)
                               else [node.target])
                    for t in targets:
                        if isinstance(t, (ast.Attribute, ast.Subscript)):
                            base = _root_name(t)
                            if base is not None and base not in local:
                                out.append(ctx.finding(
                                    self, t,
                                    f"assignment into closure/global "
                                    f"'{base}' inside traced '{fn.name}' "
                                    "happens once at trace time, not per "
                                    "call"))
                elif isinstance(node, ast.Call):
                    name = call_name(node)
                    if name == "print":
                        out.append(ctx.finding(
                            self, node,
                            f"print() inside traced '{fn.name}' runs at "
                            "trace time only; use jax.debug.print"))
                    elif (isinstance(node.func, ast.Attribute)
                            and node.func.attr in _MUTATORS):
                        base = _root_name(node.func.value)
                        if base is not None and base not in local:
                            out.append(ctx.finding(
                                self, node,
                                f"mutating call .{node.func.attr}() on "
                                f"closure/global '{base}' inside traced "
                                f"'{fn.name}'"))
        return out


@register
class TracerHostCoercion(Rule):
    id = "EDK102"
    severity = "error"
    summary = ("tracer-to-host coercion (float()/bool()/.item()/host "
               "numpy) inside a jit-traced function")
    scopes = _SCOPES

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for fn in traced_functions(ctx.tree):
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = call_name(node)
                if (name in ("float", "int", "bool") and node.args
                        and not isinstance(node.args[0], ast.Constant)):
                    out.append(ctx.finding(
                        self, node,
                        f"{name}() on a traced value inside '{fn.name}' "
                        "raises ConcretizationTypeError under jit"))
                elif (isinstance(node.func, ast.Attribute)
                        and node.func.attr in ("item", "tolist")):
                    out.append(ctx.finding(
                        self, node,
                        f".{node.func.attr}() inside traced '{fn.name}' "
                        "forces a host transfer"))
                elif name and name.split(".")[0] in ("np", "numpy"):
                    out.append(ctx.finding(
                        self, node,
                        f"host-numpy call {name}() inside traced "
                        f"'{fn.name}' is baked in as a trace-time "
                        "constant; use jnp"))
        return out


#: attributes that are static under a trace (shape metadata)
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size"}
_STATIC_CALLS = {"len", "isinstance"}


def _static_param_names(tree: ast.Module) -> "dict":
    """function name -> parameter names declared trace-static via
    ``static_argnames``/``static_argnums`` in a jit decorator
    (``@partial(jax.jit, static_argnames=...)``, ``@jax.jit(...)``) or a
    direct ``jax.jit(fn, static_argnames=...)`` call.  Branching on a
    static parameter is legal Python control flow, not a traced branch.
    """
    def str_consts(node: ast.AST) -> Set[str]:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return {node.value}
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return {e.value for e in node.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str)}
        return set()

    def int_consts(node: ast.AST) -> Set[int]:
        if isinstance(node, ast.Constant) and isinstance(node.value, int):
            return {node.value}
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return {e.value for e in node.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, int)}
        return set()

    by_name = {node.name: node for node in ast.walk(tree)
               if isinstance(node, FUNCTION_NODES)}
    static: dict = {}

    def note(fn_name: str, names: Set[str], nums: Set[int]) -> None:
        fn = by_name.get(fn_name)
        if fn is None:
            return
        pos = [a.arg for a in (list(fn.args.posonlyargs)
                               + list(fn.args.args))]
        got = set(names) | {pos[i] for i in nums if 0 <= i < len(pos)}
        static.setdefault(fn_name, set()).update(got)

    for node in ast.walk(tree):
        if isinstance(node, FUNCTION_NODES):
            for dec in node.decorator_list:
                if isinstance(dec, ast.Call):
                    names: Set[str] = set()
                    nums: Set[int] = set()
                    for kw in dec.keywords:
                        if kw.arg == "static_argnames":
                            names |= str_consts(kw.value)
                        elif kw.arg == "static_argnums":
                            nums |= int_consts(kw.value)
                    if names or nums:
                        note(node.name, names, nums)
        elif isinstance(node, ast.Call):
            target = next((a.id for a in node.args
                           if isinstance(a, ast.Name)), None)
            if target is None:
                continue
            names, nums = set(), set()
            for kw in node.keywords:
                if kw.arg == "static_argnames":
                    names |= str_consts(kw.value)
                elif kw.arg == "static_argnums":
                    nums |= int_consts(kw.value)
            if names or nums:
                note(target, names, nums)
    return static


def _tainted_names(fn: ast.AST, params: Set[str]) -> Set[str]:
    """Params plus names transitively assigned from them through
    *trace-live* expressions (fixpoint; shape/``is None``/``len()``
    derivations stay untainted — they are static under a trace)."""
    tainted = set(params)
    changed = True
    while changed:
        changed = False
        for node in ast.walk(fn):
            targets: List[ast.AST] = []
            value: Optional[ast.AST] = None
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                value = node.value
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                value, targets = node.iter, [node.target]
            elif isinstance(node, ast.NamedExpr):
                value, targets = node.value, [node.target]
            if value is None or not _has_live_taint(value, tainted):
                continue
            for t in targets:
                for leaf in ast.walk(t):
                    if (isinstance(leaf, ast.Name)
                            and leaf.id not in tainted):
                        tainted.add(leaf.id)
                        changed = True
    return tainted


def _has_live_taint(test: ast.AST, tainted: Set[str]) -> bool:
    """Does ``test`` read a tainted name outside the exempt trace-static
    constructs (``is None``, ``.shape``-family attrs, ``len()``,
    ``isinstance()``)?"""

    def scan(node: ast.AST, exempt: bool) -> bool:
        if isinstance(node, ast.Name):
            return node.id in tainted and not exempt
        if (isinstance(node, ast.Attribute)
                and node.attr in _STATIC_ATTRS):
            exempt = True
        elif isinstance(node, ast.Call):
            name = call_name(node)
            if name in _STATIC_CALLS:
                exempt = True
        elif isinstance(node, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            exempt = True
        return any(scan(child, exempt)
                   for child in ast.iter_child_nodes(node))

    return scan(test, False)


@register
class TracedValueBranch(Rule):
    id = "EDK103"
    severity = "error"
    summary = ("Python branch on a traced value; use jnp.where / "
               "lax.cond (static closure config is fine)")
    scopes = _SCOPES

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        out: List[Finding] = []
        static = _static_param_names(ctx.tree)
        for fn in traced_functions(ctx.tree):
            params = {a.arg for a in (
                list(fn.args.posonlyargs) + list(fn.args.args)
                + list(fn.args.kwonlyargs)
                + ([fn.args.vararg] if fn.args.vararg else [])
                + ([fn.args.kwarg] if fn.args.kwarg else []))}
            params -= static.get(fn.name, set())
            tainted = _tainted_names(fn, params)
            for node in ast.walk(fn):
                if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                    if _has_live_taint(node.test, tainted):
                        kind = {"If": "if", "While": "while",
                                "IfExp": "conditional expression"}[
                                    type(node).__name__]
                        out.append(ctx.finding(
                            self, node,
                            f"{kind} on a value derived from traced "
                            f"'{fn.name}' arguments evaluates at trace "
                            "time; use jnp.where or lax.cond"))
        return out


_X64_DECLS = {"jnp.float64", "jax.numpy.float64"}


def _in_x64_guard(node: ast.AST) -> bool:
    anc = parent(node)
    while anc is not None:
        if isinstance(anc, ast.With):
            for item in anc.items:
                expr = item.context_expr
                name = dotted_name(expr.func if isinstance(expr, ast.Call)
                                   else expr)
                if name and "x64" in name:
                    return True
        anc = parent(anc)
    return False


@register
class Float64OutsideGuard(Rule):
    id = "EDK104"
    severity = "error"
    summary = ("float64 requested from jax outside the enable_x64 "
               "guard; jax silently truncates to float32")
    scopes = _SCOPES

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        attach_parents(ctx.tree)
        # a module-level jax_enable_x64 config flip covers the whole file
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                name = call_name(node)
                if name and name.endswith("update") and node.args and \
                        isinstance(node.args[0], ast.Constant) and \
                        node.args[0].value == "jax_enable_x64":
                    return ()

        out: List[Finding] = []

        def flag(node: ast.AST, what: str) -> None:
            if not _in_x64_guard(node):
                out.append(ctx.finding(
                    self, node,
                    f"{what} outside the enable_x64 guard silently "
                    "becomes float32 and breaks the bit-exact "
                    "cross-engine story"))

        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Attribute):
                if dotted_name(node) in _X64_DECLS:
                    flag(node, "jnp.float64")
            elif isinstance(node, ast.Call):
                name = call_name(node)
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr == "astype" and node.args
                        and isinstance(node.args[0], ast.Constant)
                        and node.args[0].value == "float64"):
                    flag(node, '.astype("float64")')
                elif name and name.split(".")[0] in ("jnp", "jax"):
                    for kw in node.keywords:
                        if (kw.arg == "dtype"
                                and isinstance(kw.value, ast.Constant)
                                and kw.value.value == "float64"):
                            flag(node, 'dtype="float64"')
        return out


__all__ = ["SideEffectsUnderTrace", "TracerHostCoercion",
           "TracedValueBranch", "Float64OutsideGuard"]

_ = FUNCTION_NODES  # helper surface kept importable for fixtures/tests

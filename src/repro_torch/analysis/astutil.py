"""Shared AST helpers for the rule plugins.

Everything here is *heuristic* in the way a linter must be: set-type
inference tracks the syntactic forms this codebase actually uses
(``x = set()``, ``x: Set[str] = ...``, set literals), jit-trace
detection marks functions that are decorated with / passed to the JAX
tracing entry points, and name binding is computed per function tree.
The rules are tuned so every flagged site in this repo is a true
finding; genuinely intentional exceptions use ``# lint: ignore[...]``.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple, Union

FunctionNode = Union[ast.FunctionDef, ast.AsyncFunctionDef]
FUNCTION_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


def attach_parents(tree: ast.AST) -> None:
    for parent in ast.walk(tree):
        for child in ast.iter_child_nodes(parent):
            child._lint_parent = parent  # type: ignore[attr-defined]


def parent(node: ast.AST) -> Optional[ast.AST]:
    return getattr(node, "_lint_parent", None)


def dotted_name(node: ast.AST) -> Optional[str]:
    """``np.random.choice`` for nested Attribute/Name chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> Optional[str]:
    return dotted_name(call.func)


def is_set_expr(node: ast.AST, set_names: Set[str],
                set_attrs: Set[str]) -> bool:
    """Is ``node`` a set-typed expression under the module's inferred
    bindings?  Covers names, ``obj.attr`` chains, ``set(...)`` calls,
    set literals/comprehensions, and set-algebra BinOps whose either
    side is a set."""
    if isinstance(node, ast.Name):
        return node.id in set_names
    if isinstance(node, ast.Attribute):
        return node.attr in set_attrs
    if isinstance(node, ast.Call):
        name = call_name(node)
        return name in ("set", "frozenset")
    if isinstance(node, ast.Set) or isinstance(node, ast.SetComp):
        return True
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
        return (is_set_expr(node.left, set_names, set_attrs)
                or is_set_expr(node.right, set_names, set_attrs))
    return False


def _annotation_is_set(ann: ast.AST) -> bool:
    if isinstance(ann, ast.Name):
        return ann.id in ("set", "Set", "frozenset", "FrozenSet")
    if isinstance(ann, ast.Subscript):
        return _annotation_is_set(ann.value)
    if isinstance(ann, ast.Attribute):  # typing.Set[...]
        return ann.attr in ("Set", "FrozenSet")
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.split("[")[0].strip() in (
            "set", "Set", "frozenset", "FrozenSet")
    return False


class SetInference:
    """Lexically scoped set-type inference for a module.

    Attribute inference is name-based and module-wide (``self._dead =
    set()`` marks ``_dead`` everywhere) — the protocol-state attributes
    this targets (``_dead``, ``draining``, ``votes``, ``down``) have
    distinctive names.  *Name* inference is per enclosing function:
    ``removed = set(...)`` in one helper must not retype an unrelated
    local ``removed`` elsewhere in the module.  A use site sees its own
    scope's bindings plus every enclosing scope's (closure lookup).
    """

    def __init__(self, tree: ast.Module):
        attach_parents(tree)
        self.tree = tree
        self.attrs: Set[str] = set()
        self._names: Dict[int, Set[str]] = {}  # id(scope node) -> names
        self._infer()

    def _scope_of(self, node: ast.AST) -> ast.AST:
        anc = parent(node)
        while anc is not None:
            if isinstance(anc, FUNCTION_NODES + (ast.Lambda,)):
                return anc
            anc = parent(anc)
        return self.tree

    def visible_names(self, node: ast.AST) -> Set[str]:
        names: Set[str] = set()
        scope: Optional[ast.AST] = self._scope_of(node)
        while scope is not None:
            names |= self._names.get(id(scope), set())
            scope = (None if scope is self.tree
                     else self._scope_of(scope))
        return names

    def is_set(self, node: ast.AST) -> bool:
        return is_set_expr(node, self.visible_names(node), self.attrs)

    def _bind(self, target: ast.AST) -> bool:
        if isinstance(target, ast.Name):
            slot = self._names.setdefault(
                id(self._scope_of(target)), set())
            if target.id not in slot:
                slot.add(target.id)
                return True
        elif isinstance(target, ast.Attribute):
            if target.attr not in self.attrs:
                self.attrs.add(target.attr)
                return True
        return False

    def _infer(self) -> None:
        changed = True
        while changed:
            changed = False
            for node in ast.walk(self.tree):
                if isinstance(node, ast.Assign):
                    if self.is_set(node.value):
                        for t in node.targets:
                            changed |= self._bind(t)
                elif isinstance(node, ast.AnnAssign):
                    if _annotation_is_set(node.annotation) or (
                            node.value is not None
                            and self.is_set(node.value)):
                        changed |= self._bind(node.target)
                elif isinstance(node, ast.AugAssign) and isinstance(
                        node.op, (ast.BitOr, ast.BitAnd, ast.BitXor)):
                    if self.is_set(node.value):
                        changed |= self._bind(node.target)

    @property
    def empty(self) -> bool:
        return not self.attrs and not any(self._names.values())


def bound_names(fn: FunctionNode) -> Set[str]:
    """Every name bound inside ``fn``'s tree (params, assignments, for
    targets, with-as, comprehension targets, nested def names) — the
    'locals of the traced scope' for closure-mutation checks."""
    names: Set[str] = set()
    args = fn.args
    for a in (list(args.posonlyargs) + list(args.args)
              + list(args.kwonlyargs)
              + ([args.vararg] if args.vararg else [])
              + ([args.kwarg] if args.kwarg else [])):
        names.add(a.arg)
    for node in ast.walk(fn):
        if isinstance(node, FUNCTION_NODES) and node is not fn:
            names.add(node.name)
            for a in (list(node.args.posonlyargs) + list(node.args.args)
                      + list(node.args.kwonlyargs)
                      + ([node.args.vararg] if node.args.vararg else [])
                      + ([node.args.kwarg] if node.args.kwarg else [])):
                names.add(a.arg)
        elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                for leaf in ast.walk(t):
                    if isinstance(leaf, ast.Name):
                        names.add(leaf.id)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            for leaf in ast.walk(node.target):
                if isinstance(leaf, ast.Name):
                    names.add(leaf.id)
        elif isinstance(node, (ast.comprehension,)):
            for leaf in ast.walk(node.target):
                if isinstance(leaf, ast.Name):
                    names.add(leaf.id)
        elif isinstance(node, ast.withitem) and node.optional_vars:
            for leaf in ast.walk(node.optional_vars):
                if isinstance(leaf, ast.Name):
                    names.add(leaf.id)
        elif isinstance(node, ast.NamedExpr):
            if isinstance(node.target, ast.Name):
                names.add(node.target.id)
    return names


#: Call targets whose function argument is traced by JAX.
TRACE_ENTRYPOINTS = {
    "jax.jit", "jit", "pjit", "jax.pmap", "pmap", "jax.vmap", "vmap",
    "jax.grad", "jax.value_and_grad", "jax.checkpoint", "jax.remat",
    "jax.lax.scan", "lax.scan", "jax.lax.associative_scan",
    "lax.associative_scan", "jax.lax.cond", "lax.cond",
    "jax.lax.while_loop", "lax.while_loop", "jax.lax.fori_loop",
    "lax.fori_loop", "jax.lax.map", "lax.map",
    "pl.pallas_call", "pallas_call", "shard_map",
}

_JIT_DECORATORS = ("jit", "pjit", "pallas_call", "custom_vjp", "custom_jvp")


def _decorator_traces(dec: ast.AST) -> bool:
    name = dotted_name(dec if not isinstance(dec, ast.Call) else dec.func)
    if name and name.split(".")[-1] in _JIT_DECORATORS:
        return True
    # functools.partial(jax.jit, ...) as a decorator
    if isinstance(dec, ast.Call):
        fname = dotted_name(dec.func)
        if fname and fname.split(".")[-1] == "partial" and dec.args:
            inner = dotted_name(dec.args[0])
            return bool(inner) and inner.split(".")[-1] in _JIT_DECORATORS
    return False


def traced_functions(tree: ast.Module) -> List[FunctionNode]:
    """Outermost jit-traced functions of a module: decorated with a
    tracing decorator, or referenced (by name, directly or through
    ``partial``) as an argument of a trace entry point call.  Functions
    nested inside a traced function are part of the same trace and are
    covered by walking the returned roots."""
    attach_parents(tree)
    by_name: Dict[str, List[FunctionNode]] = {}
    for node in ast.walk(tree):
        if isinstance(node, FUNCTION_NODES):
            by_name.setdefault(node.name, []).append(node)

    traced: Set[FunctionNode] = set()
    for node in ast.walk(tree):
        if isinstance(node, FUNCTION_NODES):
            if any(_decorator_traces(d) for d in node.decorator_list):
                traced.add(node)
        elif isinstance(node, ast.Call):
            name = call_name(node)
            if name not in TRACE_ENTRYPOINTS:
                continue
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, ast.Call):  # partial(fn, ...)
                    pname = dotted_name(arg.func)
                    if pname and pname.split(".")[-1] == "partial" \
                            and arg.args:
                        arg = arg.args[0]
                if isinstance(arg, ast.Name):
                    traced.update(by_name.get(arg.id, []))

    # keep only outermost traced roots (a nested traced fn is covered by
    # its enclosing root's walk)
    roots: List[FunctionNode] = []
    for fn in traced:
        anc = parent(fn)
        enclosed = False
        while anc is not None:
            if anc in traced:
                enclosed = True
                break
            anc = parent(anc)
        if not enclosed:
            roots.append(fn)
    roots.sort(key=lambda f: f.lineno)
    return roots


def walk_statements(body: List[ast.stmt]) -> Iterator[ast.stmt]:
    """Statements of ``body`` in source order, recursing into compound
    statements."""
    for stmt in body:
        yield stmt
        for field in ("body", "orelse", "finalbody"):
            inner = getattr(stmt, field, None)
            if inner:
                yield from walk_statements(inner)
        for handler in getattr(stmt, "handlers", []) or []:
            yield from walk_statements(handler.body)

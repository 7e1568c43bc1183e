"""EDK2xx — EdgeKV protocol-invariant rules.

These encode the migration-lease contract as *static* checks, so
the two historical bug classes fail lint instead of needing the right
random schedule to reproduce dynamically:

* **EDK201** — the declared ``OUTCOMES`` spec must equal the lease
  lifecycle's five terminal outcomes, every declared outcome must be
  *reachable* at some release call site (a string literal passed to a
  ``release``-named call, including both arms of a conditional
  expression), and no release site may use an undeclared literal.
* **EDK202** — terminal states are absorbing: the ``release`` method
  that validates outcomes must actually remove the lease from the
  active table, and no code path may mutate or retarget a lease object
  after releasing it in the same block.
* **EDK203** — every ``tombstones`` insertion needs a revoke-on-put
  partner: some ``put``-named function must ``pop``/``del`` the key's
  tombstone entry, or a replayed delete resurrects over a fresh write
  (the delete-resurrection bug).

Cross-file checks (EDK201/EDK203) run in ``finalize`` over a
*universe*: the real source tree is one universe, while each golden
fixture file under ``tests/fixtures/lint/`` is its own self-contained
universe, so a fixture missing its revoke path cannot borrow the real
``resource_put``'s.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Sequence, Set, Tuple

from ..astutil import FUNCTION_NODES, walk_statements
from ..engine import FIXTURE_MARKER, FileContext, Finding, Rule, register

#: the lease lifecycle's terminal outcomes (core/lease.py contract)
LEASE_OUTCOMES = frozenset(
    {"copied", "superseded", "tombstone", "returned", "aborted"})


def _universes(ctxs: Sequence[FileContext]) -> List[List[FileContext]]:
    real = [c for c in ctxs if FIXTURE_MARKER not in c.path.as_posix()]
    fixtures = [c for c in ctxs if FIXTURE_MARKER in c.path.as_posix()]
    out: List[List[FileContext]] = []
    if real:
        out.append(real)
    out.extend([f] for f in fixtures)
    return out


def _outcomes_decl(ctx: FileContext) -> Optional[Tuple[ast.Assign,
                                                       Set[str]]]:
    """Module-level ``OUTCOMES = ("...", ...)`` declaration, if any."""
    for node in ctx.tree.body:
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "OUTCOMES"
                        for t in node.targets)
                and isinstance(node.value, (ast.Tuple, ast.List, ast.Set))):
            values = {e.value for e in node.value.elts
                      if isinstance(e, ast.Constant)
                      and isinstance(e.value, str)}
            if values:
                return node, values
    return None


def _release_literals(ctx: FileContext) -> List[Tuple[str, ast.AST]]:
    """(outcome-literal, node) for every string literal passed to a
    ``release``-named call, following both arms of conditional
    expressions (``"tombstone" if lease.tombstone else "superseded"``).
    """
    sites: List[Tuple[str, ast.AST]] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        fname = (node.func.attr if isinstance(node.func, ast.Attribute)
                 else node.func.id if isinstance(node.func, ast.Name)
                 else None)
        if fname is None or "release" not in fname:
            continue
        for arg in node.args:
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                sites.append((arg.value, arg))
            elif isinstance(arg, ast.IfExp):
                for branch in (arg.body, arg.orelse):
                    if (isinstance(branch, ast.Constant)
                            and isinstance(branch.value, str)):
                        sites.append((branch.value, branch))
    return sites


@register
class LeaseOutcomeSpec(Rule):
    id = "EDK201"
    severity = "error"
    summary = ("lease OUTCOMES must match the lifecycle spec, every "
               "outcome reachable at a release site, no unknown "
               "literals")
    scopes = None

    def finalize(self, ctxs: Sequence[FileContext]) -> Iterable[Finding]:
        out: List[Finding] = []
        for universe in _universes(ctxs):
            decls = [(c, d) for c in universe
                     for d in [_outcomes_decl(c)] if d is not None]
            if not decls:
                continue
            declared: Set[str] = set()
            for ctx, (node, values) in decls:
                declared |= values
                missing_spec = LEASE_OUTCOMES - values
                extra_spec = values - LEASE_OUTCOMES
                if missing_spec or extra_spec:
                    out.append(ctx.finding(
                        self, node,
                        "OUTCOMES declaration drifts from the lease "
                        f"lifecycle spec: missing {sorted(missing_spec)}, "
                        f"unexpected {sorted(extra_spec)}"))
            reached: Set[str] = set()
            for ctx in universe:
                for literal, site in _release_literals(ctx):
                    reached.add(literal)
                    if literal not in declared:
                        out.append(ctx.finding(
                            self, site,
                            f"release outcome {literal!r} is not in the "
                            "declared OUTCOMES"))
            unreached = declared - reached
            if unreached:
                ctx, (node, _values) = decls[0]
                out.append(ctx.finding(
                    self, node,
                    f"declared outcome(s) {sorted(unreached)} are never "
                    "produced at any release call site — the transition "
                    "graph lost a terminal state"))
        return out


_LEASE_MUTATORS = {"retarget", "acquire", "mark_dirty"}


@register
class TerminalIsAbsorbing(Rule):
    id = "EDK202"
    severity = "error"
    summary = ("released leases are terminal: release must drop the "
               "lease from the active table and nothing may mutate a "
               "lease after releasing it")
    scopes = None

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        out: List[Finding] = []
        decl = _outcomes_decl(ctx)
        if decl is not None:
            out.extend(self._check_release_pops(ctx))
        out.extend(self._check_use_after_release(ctx))
        return out

    def _check_release_pops(self, ctx: FileContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, FUNCTION_NODES)
                    and node.name == "release"):
                continue
            drops = False
            for inner in ast.walk(node):
                if (isinstance(inner, ast.Call)
                        and isinstance(inner.func, ast.Attribute)
                        and inner.func.attr == "pop"):
                    drops = True
                elif isinstance(inner, ast.Delete):
                    drops = True
            if not drops:
                yield ctx.finding(
                    self, node,
                    "release() validates an outcome but never removes "
                    "the lease from the active table — terminal states "
                    "must be absorbing")

    def _check_use_after_release(self,
                                 ctx: FileContext) -> Iterable[Finding]:
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, FUNCTION_NODES):
                continue
            for body in self._bodies(fn):
                released: Set[str] = set()
                for stmt in body:
                    for name in sorted(released):
                        hit = self._mutation_of(stmt, name)
                        if hit is not None:
                            yield ctx.finding(
                                self, hit,
                                f"lease '{name}' is mutated after being "
                                "released in this block; released leases "
                                "are terminal")
                    released |= self._released_in(stmt)

    @staticmethod
    def _bodies(fn: ast.AST) -> Iterable[List[ast.stmt]]:
        for node in ast.walk(fn):
            for field in ("body", "orelse", "finalbody"):
                inner = getattr(node, field, None)
                if isinstance(inner, list) and inner and \
                        isinstance(inner[0], ast.stmt):
                    yield inner

    @staticmethod
    def _released_in(stmt: ast.stmt) -> Set[str]:
        names: Set[str] = set()
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call):
                fname = (node.func.attr
                         if isinstance(node.func, ast.Attribute)
                         else node.func.id
                         if isinstance(node.func, ast.Name) else None)
                if fname and "release" in fname and node.args and \
                        isinstance(node.args[0], ast.Name):
                    names.add(node.args[0].id)
        return names

    @staticmethod
    def _mutation_of(stmt: ast.stmt, name: str) -> Optional[ast.AST]:
        for node in ast.walk(stmt):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == name):
                        return t
            elif (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == name
                    and node.func.attr in _LEASE_MUTATORS):
                return node
        return None


#: write-superseded maps: every insertion into one of these attributes
#: must have a revoke-on-put partner, or a stale entry outlives the
#: fresh write it was superseded by — ``tombstones`` resurrect a delete
#: (the delete-resurrection bug), ``hot_mirrors`` serve a superseded
#: value forever
_REVOCABLE_MAPS = ("tombstones", "hot_mirrors")


def _revocable_insertions(ctx: FileContext, attr: str) -> List[ast.AST]:
    """``<...>.<attr>.setdefault(...).add/update(...)`` calls and
    direct ``<...>.<attr>[key] = ...`` assignments."""
    sites: List[ast.AST] = []
    for node in ast.walk(ctx.tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("add", "update")
                and isinstance(node.func.value, ast.Call)
                and isinstance(node.func.value.func, ast.Attribute)
                and node.func.value.func.attr == "setdefault"
                and isinstance(node.func.value.func.value, ast.Attribute)
                and node.func.value.func.value.attr == attr):
            sites.append(node)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if (isinstance(t, ast.Subscript)
                        and isinstance(t.value, ast.Attribute)
                        and t.value.attr == attr):
                    sites.append(t)
    return sites


def _has_put_revoke(ctx: FileContext, attr: str) -> bool:
    """Does some ``put``-named function pop/del an ``<attr>`` entry?"""
    for fn in ast.walk(ctx.tree):
        if not (isinstance(fn, FUNCTION_NODES) and "put" in fn.name):
            continue
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "pop"
                    and isinstance(node.func.value, ast.Attribute)
                    and node.func.value.attr == attr):
                return True
            if isinstance(node, ast.Delete):
                for t in node.targets:
                    if (isinstance(t, ast.Subscript)
                            and isinstance(t.value, ast.Attribute)
                            and t.value.attr == attr):
                        return True
    return False


@register
class TombstoneRevokeOnPut(Rule):
    id = "EDK203"
    severity = "error"
    summary = ("insertions into a write-superseded map (tombstones, "
               "hot_mirrors) without a revoke-on-put partner let stale "
               "entries outlive fresh writes")
    scopes = None

    def finalize(self, ctxs: Sequence[FileContext]) -> Iterable[Finding]:
        out: List[Finding] = []
        for universe in _universes(ctxs):
            for attr in _REVOCABLE_MAPS:
                insertions = [(c, site) for c in universe
                              for site in _revocable_insertions(c, attr)]
                if not insertions:
                    continue
                if any(_has_put_revoke(c, attr) for c in universe):
                    continue
                for ctx, site in insertions:
                    out.append(ctx.finding(
                        self, site,
                        f"{attr} insertion has no revoke-on-put partner "
                        f"(no put-named function pops/dels the {attr} "
                        "entry): a fresh write leaves a stale entry to "
                        "resurrect or serve a superseded value"))
        return out


__all__ = ["LeaseOutcomeSpec", "TerminalIsAbsorbing",
           "TombstoneRevokeOnPut", "LEASE_OUTCOMES"]

_ = walk_statements  # helper surface kept importable for fixtures/tests

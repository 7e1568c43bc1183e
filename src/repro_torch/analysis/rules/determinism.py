"""EDK0xx — determinism rules.

The reproduction's verification story (bit-exact oracle-vs-fast
differentials, seed-replayable figures) dies quietly when anything in
the simulated universe depends on process identity: the reference once
shipped exactly that bug (open-loop arrival streams seeded from the
process-salted builtin ``hash(gid)``), and unordered-``set`` iteration
or global-RNG calls are the same bug class waiting to happen.

* **EDK001** — bare builtin ``hash()``: salted per process
  (PYTHONHASHSEED); use :func:`repro_torch.core.hashring.stable_hash`
  (or an explicit crc32/sha1) for anything that reaches ring placement,
  seeding, or replay.
* **EDK002** — iteration over ``set``-typed state without ``sorted()``:
  set order is hash order; in ``core``/``sim``/``fault`` it leaks into
  migration order, routing repair order, or error text.
* **EDK003** — module-level global-RNG calls (``random.random()``,
  ``np.random.rand()``): hidden cross-cutting state; use a seeded
  ``random.Random`` / ``np.random.default_rng`` instance.
* **EDK004** — wall-clock reads (``time.time``, ``datetime.now``, the
  ``perf_counter`` family) inside the virtual-time modules; virtual
  time is the only clock the simulation may observe.  Intentional
  walltime *reporting* suppresses with ``# lint: ignore[EDK004]``.
"""
from __future__ import annotations

import ast
from typing import Iterable, List

from ..astutil import SetInference, attach_parents, call_name, dotted_name
from ..engine import FileContext, Finding, Rule, register


@register
class BareBuiltinHash(Rule):
    id = "EDK001"
    severity = "error"
    summary = ("builtin hash() is process-salted (PYTHONHASHSEED); use "
               "hashring.stable_hash / crc32 for anything replayable")
    scopes = None  # process-salted hashing is wrong anywhere in repro

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "hash"):
                out.append(ctx.finding(
                    self, node,
                    "bare builtin hash() is salted per process and breaks "
                    "seed replay; use repro_torch.core.hashring.stable_hash "
                    "(or zlib.crc32) instead"))
        return out


#: call wrappers that consume iteration order
_ORDER_SINKS = {"list", "tuple", "iter", "enumerate", "str", "repr"}


@register
class UnorderedSetIteration(Rule):
    id = "EDK002"
    severity = "error"
    summary = ("iteration over set-typed state without sorted(): hash "
               "order reaches sim-visible behavior")
    scopes = ("repro_torch/core", "repro_torch/sim", "repro_torch/fault")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        inference = SetInference(ctx.tree)
        if inference.empty:
            return ()
        out: List[Finding] = []

        def flag(node: ast.AST, what: str) -> None:
            out.append(ctx.finding(
                self, node,
                f"{what} iterates set-typed state in hash order; wrap it "
                "in sorted() (or restructure to an ordered container)"))

        is_set = inference.is_set

        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.For, ast.AsyncFor)):
                if is_set(node.iter):
                    flag(node.iter, "for loop")
            elif isinstance(node, ast.comprehension):
                if is_set(node.iter):
                    flag(node.iter, "comprehension")
            elif isinstance(node, ast.Call):
                name = call_name(node)
                if (name in _ORDER_SINKS and node.args
                        and is_set(node.args[0])):
                    flag(node, f"{name}() call")
                elif (isinstance(node.func, ast.Attribute)
                        and node.func.attr == "join" and node.args
                        and is_set(node.args[0])):
                    flag(node, "str.join() call")
            elif isinstance(node, ast.Starred) and is_set(node.value):
                flag(node, "star-unpacking")
            elif isinstance(node, ast.FormattedValue) and is_set(node.value):
                flag(node, "f-string interpolation")
        return out


_RANDOM_GLOBALS = {
    "seed", "random", "uniform", "randint", "randrange", "choice",
    "choices", "sample", "shuffle", "getrandbits", "randbytes", "gauss",
    "normalvariate", "expovariate", "betavariate", "triangular",
    "lognormvariate", "vonmisesvariate", "paretovariate",
    "weibullvariate", "binomialvariate",
}
#: np.random attributes that are fine: explicit seeded-generator
#: construction, not draws from the hidden global state
_NP_RANDOM_OK = {"default_rng", "SeedSequence", "Generator", "PCG64",
                 "Philox", "SFC64", "MT19937", "BitGenerator"}


@register
class GlobalRandomState(Rule):
    id = "EDK003"
    severity = "error"
    summary = ("module-level global-RNG call; use a seeded "
               "random.Random / np.random.default_rng instance")
    scopes = None

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name is None:
                continue
            if name.startswith(("np.random.", "numpy.random.")):
                attr = name.rsplit(".", 1)[-1]
                if attr not in _NP_RANDOM_OK:
                    out.append(ctx.finding(
                        self, node,
                        f"{name}() draws from numpy's hidden global RNG; "
                        "use np.random.default_rng(seed)"))
            elif name.startswith("random.") and name.count(".") == 1:
                attr = name.split(".", 1)[1]
                if attr in _RANDOM_GLOBALS:
                    out.append(ctx.finding(
                        self, node,
                        f"{name}() mutates the process-global RNG; use a "
                        "seeded random.Random(seed) instance"))
        return out


_WALL_CLOCKS = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.process_time",
    "datetime.now", "datetime.utcnow", "datetime.today",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "date.today", "datetime.date.today",
}


@register
class WallClockInVirtualTime(Rule):
    id = "EDK004"
    severity = "error"
    summary = ("wall-clock read inside a virtual-time module; the sim "
               "may only observe env.now (suppress explicitly for "
               "walltime reporting)")
    scopes = ("repro_torch/core", "repro_torch/sim", "repro_torch/fault")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name in _WALL_CLOCKS:
                out.append(ctx.finding(
                    self, node,
                    f"{name}() reads the wall clock inside a virtual-time "
                    "module; results must be a function of seeds and "
                    "env.now only (walltime *reporting* should suppress "
                    "with '# lint: ignore[EDK004]')"))
        return out


# re-exported for rule-catalog introspection in docs/tests
__all__ = ["BareBuiltinHash", "UnorderedSetIteration", "GlobalRandomState",
           "WallClockInVirtualTime"]

# keep linters honest about unused imports that are part of the public
# helper surface exercised by fixtures
_ = (attach_parents, dotted_name)

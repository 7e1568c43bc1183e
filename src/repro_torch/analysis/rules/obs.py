"""EDK3xx — observability rules.

Timing must flow through one instrumented seam.  ``repro_torch.obs``
is the sole owner of the port's wall clock: every ``walltime_s``
column in a figure dict, every compile-timing probe and every kernel
build time goes through :func:`repro_torch.obs.walltime` /
:func:`repro_torch.obs.timed`, so "time" means the same thing
everywhere (and tests can assert the sim layer never reads it at all).

* **EDK301** — raw wall-clock read (``time.time``, ``perf_counter``,
  ``datetime.now``, ...) anywhere in ``repro_torch`` outside
  ``repro_torch/obs``; call :func:`repro_torch.obs.walltime` (or wrap
  with :func:`repro_torch.obs.timed`) instead.  Unlike EDK004 — which
  bans the wall clock from the *virtual-time* modules outright — this
  rule is about routing legitimate host timing through the one blessed seam,
  so there is no suppression idiom: if the read is legitimate,
  ``walltime()`` is a drop-in replacement.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable, List

from ..astutil import call_name
from ..engine import FIXTURE_MARKER, FileContext, Finding, Rule, register
from .determinism import _WALL_CLOCKS


@register
class RawWallClockOutsideObs(Rule):
    id = "EDK301"
    severity = "error"
    summary = ("raw wall-clock read outside repro_torch.obs; route host "
               "timing through repro_torch.obs.walltime() / timed()")
    scopes = None  # everywhere in repro_torch *except* the obs package

    def in_scope(self, path: Path) -> bool:
        posix = path.as_posix()
        if FIXTURE_MARKER in posix:
            return True
        return "repro_torch/obs" not in posix

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name in _WALL_CLOCKS:
                out.append(ctx.finding(
                    self, node,
                    f"{name}() reads the wall clock directly; "
                    "repro_torch.obs.walltime() is the one instrumented "
                    "clock seam (repro_torch.obs.timed() for whole-block "
                    "timing)"))
        return out


__all__ = ["RawWallClockOutsideObs"]

"""The one sanctioned wall-clock site in the tree.

Everything in this repo runs in *virtual* time except walltime
measurement of the harness itself (figure runtimes, speedup floors,
compile times).  Those call :func:`walltime`; raw ``time.perf_counter``
(or any other wall clock) anywhere outside ``repro_torch.obs`` is a lint
error (EDK301 — and EDK004 inside the virtual-time modules), so clock
misuse is grep-able to exactly one definition.
"""
from __future__ import annotations

import time
from typing import Callable, Tuple, TypeVar

T = TypeVar("T")


def walltime() -> float:
    """Monotonic wall-clock seconds (for measuring the harness, never
    the simulation — simulated time lives on ``env.now``)."""
    return time.perf_counter()


def timed(fn: Callable[[], T]) -> Tuple[T, float]:
    """Run ``fn`` and return ``(result, elapsed_walltime_seconds)``."""
    t0 = walltime()
    out = fn()
    return out, walltime() - t0

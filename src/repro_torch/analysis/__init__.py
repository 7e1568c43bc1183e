"""Static-analysis suite for the PyTorch port (``repro_torch.analysis``).

The port of :mod:`repro.analysis`, rule for rule: the same twelve rules,
ids, severities, suppression syntax, findings and CLI, with every path
scope pointing at the port's own tree (``repro_torch/core``,
``repro_torch/sim``, ...).  It uses the standard library alone, so
``python -m repro_torch.analysis`` loads no tensor library.

The bitwise engine differentials and the seed-replayable figures of the
port silently assume the stack is *deterministic*, and the protocol
layer it shares with the reference carries invariants (lease
lifecycle, tombstone accounting) that example tests only probe
dynamically.  This package checks those assumptions at diff time:

* **EDK0xx — determinism** :mod:`repro_torch.analysis.rules.determinism`:
  process-salted ``hash()``, unordered iteration over ``set``-typed
  protocol state, module-level global-RNG calls, wall-clock reads
  inside virtual-time modules.
* **EDK1xx — jit purity** :mod:`repro_torch.analysis.rules.jitpurity`:
  side effects and closure mutation inside jit-traced functions,
  tracer-to-host coercions, data-dependent Python branches on traced
  values, float64 outside the x64 guard.  Its trace roots are JAX's
  (``jax.jit``, ``pallas_call``, ...); the port traces none, so over
  ``src/repro_torch`` these rules find nothing.  They stay so that the
  catalog equals the reference's.
* **EDK2xx — protocol invariants**
  :mod:`repro_torch.analysis.rules.protocol`: the
  :class:`~repro_torch.core.lease.MigrationLease` transition graph
  against its declared spec, and tombstone insert/revoke pairing (the
  delete-resurrection bug class).
* **EDK3xx — observability** :mod:`repro_torch.analysis.rules.obs`:
  host timing only through :func:`repro_torch.obs.walltime`.

Run ``python -m repro_torch.analysis src/repro_torch`` (exit 0 when
clean); see :mod:`repro_torch.analysis.engine` for the rule plugin
protocol and the ``# lint: ignore[RULE]`` suppression syntax.
"""
from __future__ import annotations

from .engine import (Finding, Rule, RULES, analyze_paths, iter_py_files,
                     register)
from . import rules as _rules  # noqa: F401  (registers the rule plugins)

__all__ = ["Finding", "Rule", "RULES", "analyze_paths", "iter_py_files",
           "register"]

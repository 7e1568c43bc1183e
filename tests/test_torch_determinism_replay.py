"""PYTHONHASHSEED replay regression for the port's simulator.

The whole simulated universe must be a function of the explicit seeds:
the same seeded scenario run through ``repro_torch.sim`` in two
interpreters with *different* ``PYTHONHASHSEED`` values must produce
bit-identical traces (builtin ``hash()`` seeding or unordered-set
iteration on the hot path shows up as a digest mismatch), and the same
digest as the reference package's run of the scenario.
"""
from __future__ import annotations

import contextlib
import io
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_SCRIPT = """\
import hashlib
import json

import numpy as np

from {pkg}.sim.cluster import SimEdgeKV

sim = SimEdgeKV(setting="edge", group_sizes=(3, 3, 3), seed=7,
                engine="oracle")
sim.env.process(sim.churn_proc(t_start=0.02, period=0.05, adds=1,
                               async_handoff=True, lease_batch=4,
                               lease_period=0.01))
sim.run_closed_loop(threads_per_client=4, ops_per_client=40,
                    workload_kw=dict(p_global=0.5, n_records=200,
                                     distribution="zipfian"))

h = hashlib.sha256()
arr = sim.records.columns()
for name in sorted(arr):
    h.update(name.encode())
    h.update(np.ascontiguousarray(arr[name]).tobytes())
h.update(json.dumps(sim.handoff_stats, sort_keys=True).encode())
h.update(json.dumps(sorted(sim.churn_events), default=str).encode())
print(h.hexdigest())
"""


def _digest(hashseed: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               PYTHONHASHSEED=hashseed)
    proc = subprocess.run([sys.executable, "-c",
                           _SCRIPT.format(pkg="repro_torch")],
                          capture_output=True, text=True, cwd=REPO,
                          env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip()


def test_replay_identical_across_hash_seeds():
    """Same seed, different PYTHONHASHSEED => identical RecordArray
    digest (op traces, lease counters, churn log)."""
    d0 = _digest("0")
    d1 = _digest("1")
    assert len(d0) == 64
    assert d0 == d1, (
        "trace digest depends on PYTHONHASHSEED — something on the hot "
        "path iterates hash order or seeds from builtin hash()")


def test_replay_digest_matches_reference():
    """The reference package's run of the same scenario, in this
    process, gives the port's digest."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        exec(_SCRIPT.format(pkg="repro"), {"__name__": "replay"})
    assert out.getvalue().strip() == _digest("0")

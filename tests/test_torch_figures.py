"""Every figure runner of ``repro_torch.sim.experiments`` against the
reference's ``repro.sim.experiments`` at the reference tests' small
sizes: the same rows, key by key.

* Host-engine figures (fast engine and oracle) are bitwise equal on
  every key except the host-dependent ones ``benchmarks/run.py`` leaves
  ungated (wall times).
* Sweep-backed figures (``fig13_request_rate`` on its fast branch,
  ``fig_sweep``, ``fig_scale(engine="sweep")``), run with
  ``device="cpu"``, are within 1e-9 relative per value, the sweep
  engine's contract (``tests/test_torch_sweep.py``).
"""
import inspect
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.sim import experiments as ref
from repro_torch.sim import experiments as port

# the host-dependent row keys benchmarks/run.py's --check never gates
UNGATED = ("walltime", "speedup", "_us", "per_device_scaling",
           "roofline", "kernel.", "compile")
TOL = 1e-9
CPU = dict(device="cpu")

# (figure, keyword arguments) for the host engines, both engines where
# the figure takes one
HOST = [
    ("fig5_6_locality", dict(ops_per_client=1500)),
    ("fig7_8_distributions", dict(ops_per_client=300)),
    ("fig9_10_clients_local", dict(client_counts=(20, 60),
                                   total_ops=1200)),
    ("fig11_12_clients_global", dict(client_counts=(30, 90),
                                     total_ops=1200)),
    ("fig13_request_rate", dict(rates=(100, 200), duration=0.5,
                                engine="oracle")),
    ("fig_churn", dict(ops_per_client=500)),
    ("fig_churn", dict(ops_per_client=500, async_handoff=True)),
    ("fig_handoff", dict(ops_per_client=500)),
    ("fig_failover", dict(ops_per_client=400)),
    ("fig_scenarios", dict(base_groups=6, clients_per_group=10,
                           ops_per_client=200, rate_per_client=120.0,
                           duration=0.6)),
    ("fig_trace", dict(ops_per_client=60, threads=6)),
    ("fig_scale", dict(groups=3, clients_per_group=8, ops_per_client=64,
                       seed=1)),
]
HOST_CASES = []
for _name, _kw in HOST:
    if "engine" in inspect.signature(getattr(ref, _name)).parameters \
            and "engine" not in _kw:
        HOST_CASES += [(_name, dict(_kw, engine=e))
                       for e in ("fast", "oracle")]
    else:
        HOST_CASES.append((_name, _kw))
HOST_CASES.append(("fig_rebalance", {}))

# sweep-backed: (figure, keyword arguments for both, extra for the port)
SWEEP_CASES = [
    ("fig13_request_rate", dict(rates=(100, 200), duration=1.0), CPU),
    ("fig_sweep", dict(duration=0.5), CPU),
    ("fig_sweep", dict(duration=0.5, scan_backend="assoc"), CPU),
    ("fig_scale", dict(groups=3, clients_per_group=8, ops_per_client=64,
                       seed=1, engine="sweep"), CPU),
]


def _case_id(case):
    name, kw = case[0], case[1]
    return name + "".join(f"-{k}={v}" for k, v in kw.items()
                          if k in ("engine", "async_handoff",
                                   "scan_backend"))


def _gated(key):
    return not any(tag in key for tag in UNGATED)


def _bits(v):
    """A row value in a form whose equality is bitwise."""
    if isinstance(v, float) or isinstance(v, np.floating):
        return ("f", np.float64(v).tobytes())
    return (type(v).__name__, v)


def _is_num(v):
    return isinstance(v, (int, float, np.integer, np.floating)) \
        and not isinstance(v, (bool, np.bool_))


@pytest.mark.parametrize("case", HOST_CASES, ids=_case_id)
def test_host_figure_bitwise_matches_reference(case):
    name, kw = case
    want = getattr(ref, name)(**kw)
    got = getattr(port, name)(**kw)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            if _gated(k):
                assert _bits(g[k]) == _bits(w[k]), (name, k, g[k], w[k])


@pytest.mark.parametrize("case", SWEEP_CASES, ids=_case_id)
def test_sweep_figure_matches_reference(case):
    name, kw, extra = case
    want = getattr(ref, name)(**kw)
    got = getattr(port, name)(**kw, **extra)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            if not _gated(k):
                continue
            if _is_num(w[k]):
                # nan where the point has no op of the kind
                assert math.isnan(g[k]) == math.isnan(w[k]), (name, k)
                if not math.isnan(w[k]):
                    assert abs(g[k] - w[k]) <= TOL * max(1.0, abs(w[k])), \
                        (name, k, g[k], w[k])
            else:
                assert g[k] == w[k], (name, k)


@pytest.mark.parametrize("engine", ["fast", "oracle"])
def test_headline_claims_match_reference(engine):
    ops = 3000 if engine == "fast" else 600
    want = ref.headline_claims(ops_per_client=ops, engine=engine)
    got = port.headline_claims(ops_per_client=ops, engine=engine)
    assert [type(c).__name__ for c in got] == ["ClaimCheck"] * 4
    assert [vars(c) for c in got] == [vars(c) for c in want]


@pytest.mark.parametrize("name,kw", [
    ("fig13_request_rate", dict(rates=(100,), duration=0.5)),
    ("fig_sweep", dict(duration=0.5)),
    ("fig_scale", dict(groups=3, clients_per_group=4, ops_per_client=16,
                       engine="sweep")),
])
def test_sweep_figures_default_to_the_gpu(name, kw):
    fn = getattr(port, name)
    assert inspect.signature(fn).parameters["device"].default is None
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="GPU"):
        fn(**kw)


def test_fig_scale_sweep_devices_not_supported():
    with pytest.raises(NotImplementedError):
        port.fig_scale(groups=3, clients_per_group=4, ops_per_client=16,
                       engine="sweep", devices=2, device="cpu")


def _public(mod):
    return {n: f for n, f in vars(mod).items()
            if inspect.isfunction(f) and f.__module__ == mod.__name__
            and not n.startswith("_")}


def test_same_figure_functions_and_signatures():
    """Every figure runner the reference has, under its name, with its
    parameters and defaults; the port adds only ``device`` to the three
    sweep-backed runners, and ``fig_sweep``'s scan default is the open
    loop's kernel (None) where the reference names its XLA scan."""
    want, got = _public(ref), _public(port)
    assert set(got) == set(want)
    for name, fn in want.items():
        w = inspect.signature(fn).parameters
        g = dict(inspect.signature(got[name]).parameters)
        if name in ("fig13_request_rate", "fig_sweep", "fig_scale"):
            assert list(g)[-1] == "device"
            del g["device"]
        assert list(g) == list(w), name
        for p in w:
            if (name, p) == ("fig_sweep", "scan_backend"):
                assert w[p].default == "assoc" and g[p].default is None
                continue
            assert g[p].default == w[p].default, (name, p)


def test_figures_import_with_jax_blocked():
    src = Path(__file__).resolve().parents[1] / "src"
    code = ("import sys; sys.modules['jax'] = None; "
            "import repro_torch.sim.experiments, repro_torch.fault; "
            "import repro_torch.sim.rebalance; "
            "assert 'repro' not in sys.modules")
    proc = subprocess.run([sys.executable, "-c", code],
                          env=dict(os.environ, PYTHONPATH=str(src)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr

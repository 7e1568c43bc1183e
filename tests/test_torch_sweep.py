"""The port's sweep engine against the reference: one closed-loop round
bitwise on the reference's own padded inputs, whole open- and closed-loop
sweeps to <= 1e-9 per column, the host (eviction) path, non-convergence,
and the port's closed sweep against the port's own fast engine."""
from dataclasses import asdict

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from repro.sim import sweep as ref_sweep
from repro_torch.sim import SimEdgeKV
from repro_torch.sim import sweep
from repro_torch.sim.cluster import ServiceParams

TOL = 1e-9


def port_points(points):
    return [sweep.SweepPoint(**asdict(p)) for p in points]


def assert_columns_match(got, want):
    assert set(got.columns) == set(want.columns)
    for name, w in want.columns.items():
        g = got.columns[name]
        assert g.shape == w.shape, name
        assert np.array_equal(np.isnan(g), np.isnan(w)), name
        ok = ~np.isnan(w)
        assert np.all(np.abs(g[ok] - w[ok])
                      <= TOL * np.maximum(1.0, np.abs(w[ok]))), \
            (name, g, w)


def closed_block(points, service=None, seed=0):
    """The reference's padded device block for a closed grid."""
    dm = ref_sweep._DelayModel(ref_sweep.SETTINGS["edge"],
                               service or ref_sweep.ServiceParams())
    built = [ref_sweep._closed_point_build(p, seed, dm, 2500, 1)
             for p in points]
    blk = ref_sweep._closed_assemble(built)
    R = len(blk["rows"])
    Ls = max(len(m) for m in blk["rows"])
    flat, aux = ref_sweep._closed_pad(blk, blk["n"], R, Ls)
    max_hops = max(b["max_hops"] for b in built)
    return flat, aux, dict(max_hops=max_hops, seek=float(dm.seek), R=R,
                           Ls=Ls)


CLOSED4 = ref_sweep.closed_grid(p_globals=(0.0, 1.0), contention=(10_000,),
                                groups=(3, 5), threads=4, ops=40)


@pytest.mark.parametrize("max_rounds", [1, 3, 200])
def test_closed_rounds_bitwise_on_reference_inputs(max_rounds):
    """Rounds of the fixed point on the reference's own ``_closed_pad``
    output: completions, start times, span pieces, convergence flag and
    round count all bitwise equal (200 rounds runs to convergence)."""
    flat, aux, g = closed_block(CLOSED4)
    run = ref_sweep._closed_round_fn(g["max_hops"], "seq", True,
                                     max_rounds, g["seek"], g["R"], g["Ls"])
    with jax.enable_x64():
        want = jax.device_get(jax.jit(run)(
            {k: jnp.asarray(v) for k, v in flat.items()},
            {k: jnp.asarray(v) for k, v in aux.items()}))
    got = sweep._closed_fixed_point(
        sweep.to_device(flat, "cpu"), sweep.to_device(aux, "cpu"),
        scan_backend="seq", max_rounds=max_rounds, **g)
    w_comp, w_t0, w_done, w_rounds, w_pieces = want
    comp, t0, done, rounds, pieces = got
    assert np.array_equal(comp.numpy(), w_comp)
    assert np.array_equal(t0.numpy(), w_t0)
    assert np.array_equal(pieces.numpy(), w_pieces)
    assert (done, rounds) == (bool(w_done), int(w_rounds))
    assert done == (max_rounds == 200)


def test_to_device_keeps_dtypes():
    flat, aux, _ = closed_block(CLOSED4[:1])
    for cols in (flat, aux):
        for k, v in sweep.to_device(cols, "cpu").items():
            assert v.numpy().dtype == cols[k].dtype, k


def test_closed_sweep_matches_reference():
    got = sweep.run_sweep(port_points(CLOSED4), loop="closed", device="cpu")
    want = ref_sweep.run_sweep(CLOSED4, loop="closed")
    assert_columns_match(got, want)
    assert np.array_equal(got.columns["ops"], want.columns["ops"])
    assert got.info["rounds"] > 1 and got.info["device"] == "cpu"


@pytest.mark.parametrize("scan_backend", [None, "assoc"])
def test_open_sweep_matches_reference(scan_backend):
    grid = ref_sweep.sweep_grid()[::8]
    assert len(grid) == 8
    got = sweep.run_sweep(port_points(grid), device="cpu",
                          scan_backend=scan_backend)
    want = ref_sweep.run_sweep(grid)
    assert_columns_match(got, want)


def test_closed_sweep_eviction_regime_matches_reference():
    """A page cache smaller than the working set takes the host-side
    fixed point with the exact LRU replay."""
    pts = [ref_sweep.SweepPoint(p_global=0.5, groups=3, threads=8, ops=64),
           ref_sweep.SweepPoint(p_global=0.0, groups=3, threads=8, ops=64,
                                distribution="zipfian")]
    got = sweep.run_sweep(port_points(pts), loop="closed", device="cpu",
                          service=ServiceParams(page_cache_keys=16))
    want = ref_sweep.run_sweep(
        pts, loop="closed",
        service=ref_sweep.ServiceParams(page_cache_keys=16))
    assert_columns_match(got, want)
    assert got.info["rounds"] is None


def test_closed_sweep_nonconvergence_and_devices_raise():
    p = sweep.SweepPoint(p_global=0.5, groups=3, threads=4, ops=40)
    with pytest.raises(RuntimeError):
        sweep.run_sweep([p], loop="closed", max_rounds=1, device="cpu")
    with pytest.raises(NotImplementedError):
        sweep.run_sweep([p], loop="closed", devices=2, device="cpu")
    with pytest.raises(ValueError):
        sweep.run_sweep([p], scan_backend="pallas", device="cpu")


def test_closed_sweep_matches_port_fast_engine():
    p = sweep.SweepPoint(p_global=0.5, groups=4, threads=6, ops=48,
                         distribution="zipfian")
    res = sweep.run_sweep([p], loop="closed", device="cpu")
    sim = SimEdgeKV(setting="edge", seed=0, group_sizes=(3,) * 4,
                    engine="fast")
    sim.run_closed_loop(threads_per_client=p.threads, ops_per_client=p.ops,
                        workload_kw=dict(p_global=p.p_global,
                                         distribution=p.distribution,
                                         n_records=p.n_records),
                        seed_offset=0)
    row = res.row(0)
    for name, want in [
            ("ops", len(sim.records)),
            ("mean_latency", sim.mean_latency()),
            ("read_latency", sim.mean_latency(kind="read")),
            ("update_latency", sim.mean_latency(kind="update")),
            ("global_latency", sim.mean_latency(dtype="global")),
            ("update_global_latency",
             sim.mean_latency(kind="update", dtype="global")),
            ("throughput", sim.throughput()),
            ("p95_latency", sim.tail_latency(95)),
            ("p99_latency", sim.tail_latency(99))]:
        assert abs(row[name] - want) <= TOL * max(1.0, abs(want)), name

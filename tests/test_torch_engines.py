"""The port's simulator engines against the reference's: the same
``SimEdgeKV`` runs, on the same seeds, through ``repro.sim`` and
``repro_torch.sim`` give the same bits — every ``RecordArray`` column,
the churn log, the lease counters and every other counter a figure
reads — for the vectorized fast engine and the generator oracle alike.

Both packages run identical host code on identical seeds, so the
contract is bitwise, tighter than the reference's own 2% fast-versus-
oracle tolerance."""
import numpy as np
import pytest

from repro import sim as ref_sim
from repro_torch import sim as port_sim

ENGINES = ("fast", "oracle")


def _closed(sim_mod, engine):
    sim = sim_mod.SimEdgeKV(setting="edge", group_sizes=(3, 3, 3), seed=0,
                            engine=engine)
    sim.run_closed_loop(threads_per_client=10, ops_per_client=100,
                        workload_kw=dict(p_global=0.5))
    return sim


def _closed_cloud_zipf(sim_mod, engine):
    sim = sim_mod.SimEdgeKV(setting="cloud", group_sizes=(3,) * 4, seed=2,
                            engine=engine, virtual_nodes=4)
    sim.run_closed_loop(threads_per_client=12, ops_per_client=150,
                        workload_kw=dict(p_global=0.7, n_records=800,
                                         distribution="zipfian"))
    return sim


def _open(sim_mod, engine):
    sim = sim_mod.SimEdgeKV(setting="edge", group_sizes=(3, 3, 3), seed=1,
                            engine=engine)
    sim.run_open_loop(rate_per_client=200, duration=0.5,
                      workload_kw=dict(p_global=0.5, n_records=500))
    return sim


def _churn_open(sim_mod, engine):
    sim = sim_mod.SimEdgeKV(setting="edge", group_sizes=(3,) * 6, seed=1,
                            engine=engine)
    sim.env.process(sim.churn_proc(t_start=0.05, period=0.1, adds=2,
                                   async_handoff=True, lease_batch=8,
                                   lease_period=0.02))
    sim.run_open_loop(rate_per_client=150, duration=0.6,
                      workload_kw=dict(p_global=0.5, n_records=1000))
    return sim


def _churn_closed(sim_mod, engine):
    # small lease batches on a zipfian keyspace: reads pull in-flight
    # keys, writes supersede them, in-flight ops are redirected
    sim = sim_mod.SimEdgeKV(setting="edge", group_sizes=(3,) * 4, seed=1,
                            engine=engine)
    sim.env.process(sim.churn_proc(t_start=0.05, period=0.1, adds=2,
                                   async_handoff=True, lease_batch=2,
                                   lease_period=0.05))
    sim.run_closed_loop(threads_per_client=20, ops_per_client=300,
                        workload_kw=dict(p_global=0.5, n_records=200,
                                         distribution="zipfian"))
    return sim


def _crash(async_handoff):
    def run(sim_mod, engine):
        # the victim joins client-free (a group with load-generating
        # clients attached cannot crash) and owns hot keys when it
        # crashes, so reads are lost until its mirror is promoted
        sim = sim_mod.SimEdgeKV(setting="edge", group_sizes=(3,) * 6,
                                seed=0, engine=engine)
        base = tuple(sim.groups)
        victim = sim.add_group(3)[0]
        sim.env.process(sim.fault_proc(victims=(victim,), t_crash=0.2,
                                       heartbeat_period=20e-3,
                                       async_handoff=async_handoff))
        sim.run_closed_loop(threads_per_client=20, ops_per_client=300,
                            workload_kw=dict(p_global=0.8, n_records=300,
                                             distribution="zipfian"),
                            client_groups=base)
        return sim
    return run


def _crash_open(sim_mod, engine):
    sim = sim_mod.SimEdgeKV(setting="edge", group_sizes=(3,) * 4, seed=1,
                            engine=engine)
    base = tuple(sim.groups)
    victim = sim.add_group(3)[0]
    sim.env.process(sim.fault_proc(victims=(victim,), t_crash=0.1))
    sim.run_open_loop(rate_per_client=200, duration=0.5,
                      workload_kw=dict(p_global=0.5), client_groups=base)
    return sim


def _gateway_cache_closed(sim_mod, engine):
    sim = sim_mod.SimEdgeKV(setting="edge", group_sizes=(3,) * 6, seed=0,
                            gateway_cache=2048, engine=engine)
    sim.run_closed_loop(threads_per_client=10, ops_per_client=150,
                        workload_kw=dict(p_global=0.7, n_records=800,
                                         distribution="zipfian"))
    return sim


def _gateway_cache_open(sim_mod, engine):
    sim = sim_mod.SimEdgeKV(setting="edge", group_sizes=(3,) * 6, seed=0,
                            gateway_cache=4096, engine=engine)
    sim.run_open_loop(rate_per_client=200, duration=0.4,
                      workload_kw=dict(p_global=0.9, n_records=500,
                                       distribution="zipfian"))
    return sim


def _trace(sim_mod, engine):
    sim = sim_mod.SimEdgeKV(setting="edge", group_sizes=(3, 3, 3), seed=0,
                            engine=engine, trace=True)
    sim.run_closed_loop(threads_per_client=6, ops_per_client=60,
                        workload_kw=dict(p_global=0.5))
    return sim


CASES = {
    "closed": _closed,
    "closed_cloud_zipf_vnodes": _closed_cloud_zipf,
    "open": _open,
    "churn_async_open": _churn_open,
    "churn_async_closed": _churn_closed,
    "crash_recover": _crash(False),
    "crash_recover_async": _crash(True),
    "crash_recover_open": _crash_open,
    "gateway_cache_closed": _gateway_cache_closed,
    "gateway_cache_open": _gateway_cache_open,
    "stage_boundaries": _trace,
}


def observed(sim):
    """Everything a run leaves that a figure or a test reads, as plain
    values: columns as (dtype, bytes) so equality is bitwise."""
    cols = sim.records.columns()
    return dict(
        columns={k: (v.dtype.str, v.shape, v.tobytes())
                 for k, v in cols.items()},
        churn_events=list(sim.churn_events),
        handoff_stats=dict(sim.handoff_stats),
        leases_pending=sorted(sim.leases),
        lost_ops=sim.lost_ops,
        refusals=dict(sim.refusals),
        partition_events=list(sim.partition_events),
        hot_stats=dict(sim.hot_stats),
        gw_cache={gw: (c.hits, c.misses, list(c._d.items()))
                  for gw, c in sim.gw_cache.items()},
        ring_stabilized=sim.ring.stabilized,
        now=sim.env.now,
    )


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", list(CASES))
def test_port_engine_bitwise_matches_reference(case, engine):
    want = observed(CASES[case](ref_sim, engine))
    got = observed(CASES[case](port_sim, engine))
    assert set(got) == set(want)
    assert len(want["columns"]["latency"][2]) > 0
    if case.startswith("churn"):
        assert want["handoff_stats"]["leased"] > 0
    if case.startswith("crash"):
        assert [e[1] for e in want["churn_events"]][-2:] == ["crash",
                                                             "recover"]
    for key in want:
        assert got[key] == want[key], (case, engine, key)


def test_stage_boundary_columns_present():
    """The traced case compares the stage-boundary columns too."""
    from repro_torch.obs import BOUNDARY_FIELDS
    cols = _trace(port_sim, "fast").records.columns()
    assert set(BOUNDARY_FIELDS) <= set(cols)
    assert np.all(np.isfinite(cols[BOUNDARY_FIELDS[-1]]))


@pytest.mark.parametrize("case", ["closed", "stage_boundaries"])
def test_port_fast_engine_matches_port_oracle(case):
    """The reference's cross-engine contract, run on the port alone: a
    closed-loop run with no churn is bit-identical across its engines."""
    fast = CASES[case](port_sim, "fast").records.columns()
    oracle = CASES[case](port_sim, "oracle").records.columns()
    for k in ("t_start", "latency", "kind", "dtype", "hops"):
        assert np.array_equal(fast[k], oracle[k]), k

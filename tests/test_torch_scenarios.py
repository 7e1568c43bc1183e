"""The port's crash-recovery coordinator, scenario layer and rebalancing
controller against the reference's: the same recovery timeline, the same
rate profiles, bitwise-equal runs under every scenario event on both
engines, and the same controller decisions tick by tick."""
import numpy as np
import pytest

from repro import core as ref_core, fault as ref_fault, sim as ref_sim
from repro.sim import rebalance as ref_rebalance
from repro_torch import core as port_core, fault as port_fault
from repro_torch import sim as port_sim
from repro_torch.sim import rebalance as port_rebalance

PORT = (port_core, port_fault, port_sim, port_rebalance)
REF = (ref_core, ref_fault, ref_sim, ref_rebalance)


# ------------------------------------------------ FailureCoordinator
def _recovery(pkg, seed, victims, beats):
    """``test_fault_detector.py::test_coordinator_pipeline_timeline``'s
    run, with the seed, victims and warm-up as parameters."""
    core, fault = pkg[0], pkg[1]
    c = core.EdgeKVCluster([3] * 5, seed=seed, backup_groups=True,
                           backup_depth=2)
    keys = {f"k/{i}": i for i in range(40)}
    for k, v in keys.items():
        c.put(k, v, core.GLOBAL, client_group="g0")
    for g in c.groups.values():
        for _ in range(10):
            g.raft.step()
    coord = fault.FailureCoordinator(c, heartbeat_period=0.05, seed=1)
    coord.warmup(beats=beats)
    for gid in victims:
        coord.crash(gid)
    coord.run_recovery()
    lost = [k for k, v in keys.items()
            if c.get(k, core.GLOBAL, client_group="g0").value != v]
    return coord, c, lost


@pytest.mark.parametrize("seed,victims,beats", [
    (3, ("g2",), 10), (5, ("g1",), 20), (3, ("g2", "g4"), 10)])
def test_coordinator_timeline_matches_reference(seed, victims, beats):
    ref, ref_c, ref_lost = _recovery(REF, seed, victims, beats)
    got, c, lost = _recovery(PORT, seed, victims, beats)
    assert isinstance(got.timeline[0], port_fault.RecoveryEvent)
    assert [(e.t, e.step, e.detail) for e in got.timeline] == \
        [(e.t, e.step, e.detail) for e in ref.timeline]
    assert got.unavailability_window() == ref.unavailability_window() > 0
    assert c.ring.stabilized and ref_c.ring.stabilized
    assert lost == ref_lost == []
    steps = [e.step for e in got.timeline]
    assert steps.count("promote") == len(victims)
    assert steps.index("suspect") < steps.index("promote")


def test_coordinator_before_any_crash():
    got, _, _ = _recovery(PORT, 3, (), 5)
    assert [e.step for e in got.timeline] == ["heartbeat-warmup"]
    assert got.unavailability_window() is None


# ------------------------------------------------------------ scenarios
def _events(sim_mod, name):
    """One scenario per event kind, built from ``sim_mod``'s classes
    (sizes from ``tests/test_scenarios.py``)."""
    P, RF = sim_mod.Partition, sim_mod.RegionalFailure
    FC, D = sim_mod.FlashCrowd, sim_mod.Diurnal
    return {
        "partition": (P(t_start=0.02, duration=0.3, side=("g4", "g5"),
                        straddle=(("g3", 2),)),),
        "regional_failure": (RF(t_start=0.05, gids=("g5", "g6"),
                                rejoin=True),),
        "flash_crowd": (FC(t_start=0.3, duration=0.3, factor=4.0,
                           gids=("g0",)),),
        "diurnal": (D(period=0.25, factor=2.5),),
        "composed": (FC(t_start=0.2, duration=0.5, factor=2.0,
                        gids=("g0",)),
                     D(period=0.5, factor=1.5)),
    }[name]


def _scenario_run(sim_mod, name, engine):
    sc = sim_mod.Scenario(name, events=_events(sim_mod, name))
    if name == "partition":
        sim = sim_mod.SimEdgeKV(setting="edge", seed=3,
                                group_sizes=(3,) * 6, engine=engine)
        sc.install(sim)
        sim.run_closed_loop(threads_per_client=8, ops_per_client=400,
                            workload_kw=dict(p_global=0.5, n_records=2000),
                            client_groups=("g0", "g1", "g2", "g3"))
        return sim, None
    if name == "regional_failure":
        sim = sim_mod.SimEdgeKV(setting="edge", seed=1,
                                group_sizes=(3,) * 5, engine=engine)
        base = tuple(sim.groups)
        for _ in range(2):
            sim.add_group(3)
        sc.install(sim)
        sim.run_closed_loop(threads_per_client=8, ops_per_client=400,
                            workload_kw=dict(p_global=0.5, n_records=2000),
                            client_groups=base)
        return sim, None
    sim = sim_mod.SimEdgeKV(setting="edge", seed=9, group_sizes=(3,) * 3,
                            engine=engine)
    sc.install(sim)
    profs = sc.profiles(sim, 1.0)
    sim.run_open_loop(rate_per_client=300, duration=1.0,
                      workload_kw=dict(p_global=0.5, n_records=2000),
                      rate_profiles=profs)
    return sim, profs


SCENARIOS = ("partition", "regional_failure", "flash_crowd", "diurnal",
             "composed")


@pytest.mark.parametrize("engine", ["fast", "oracle"])
@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_run_bitwise_matches_reference(name, engine):
    ref, ref_profs = _scenario_run(ref_sim, name, engine)
    got, profs = _scenario_run(port_sim, name, engine)
    assert profs == ref_profs
    a, b = got.records.columns(), ref.records.columns()
    assert set(a) == set(b)
    for k in b:
        assert a[k].dtype == b[k].dtype and \
            a[k].tobytes() == b[k].tobytes(), k
    assert got.refusals == ref.refusals
    assert got.partition_events == ref.partition_events
    assert got.churn_events == ref.churn_events
    assert got.lost_ops == ref.lost_ops
    assert got.metrics() == ref.metrics()
    if name == "partition":
        assert got.refusals["cross_cut"] + got.refusals["no_quorum"] > 0
    if name == "regional_failure":
        evs = [e[1] for e in got.churn_events]
        assert evs.count("crash") == 2 and evs.count("rejoin") == 2
    if name in ("flash_crowd", "diurnal", "composed"):
        assert profs


def test_rate_profiles_and_windows_match_reference():
    specs = {}
    for mod in (ref_sim, port_sim):
        specs[mod] = [
            mod.Scenario("s", events=(
                mod.FlashCrowd(t_start=0.2, duration=0.3, factor=3.0,
                               gids=("g1",)),
                mod.Partition(t_start=0.1, duration=0.4, side=("g2",)),
                mod.Partition(t_start=0.7, duration=0.1, side=("g0",)))),
            mod.Scenario("d", events=(
                mod.Diurnal(period=0.25, factor=2.0, order=("g2", "g0")),
                mod.Diurnal(period=0.4, factor=1.5, t_start=0.1))),
            mod.Scenario("flat", events=(
                mod.RegionalFailure(t_start=0.1, gids=("g1",)),)),
        ]
    order = ("g0", "g1", "g2")
    for got, want in zip(specs[port_sim], specs[ref_sim]):
        assert got.partition_windows() == want.partition_windows()
        for gid in order + ("g9",):
            for dur in (1.0, 0.55):
                assert got.rate_profile(gid, order, dur) == \
                    want.rate_profile(gid, order, dur)


# ------------------------------------------------------- rebalancing
_WL = dict(p_global=1.0, n_records=60, distribution="zipfian",
           read_prop=0.95, update_prop=0.05, hotset_frac=0.2,
           hot_op_frac=0.85)


def _controlled_run(pkg, engine):
    """``tests/test_rebalance.py``'s controlled run, logging the ring
    weights, hot keys and actuation counters after every tick."""
    sim_mod, rebalance = pkg[2], pkg[3]
    sim = sim_mod.SimEdgeKV(setting="edge", group_sizes=(3,) * 4,
                            service=sim_mod.ServiceParams(read_s=1.0e-3),
                            seed=0, engine=engine, virtual_nodes=4)
    ctl = rebalance.RebalanceController(
        sim, period=0.05, ticks=8, top_k=3, hot_min_hits=4, quantum=0.5,
        deadband=0.3, min_window=30)
    ticks = []
    tick = ctl._tick

    def logged_tick():
        acted = tick()
        ticks.append((sim.env.now, acted, dict(sim.ring.weights),
                      sorted(sim.hot_keys), dict(sim.hot_stats),
                      dict(sim.handoff_stats), ctl.last_sample))
        return acted

    ctl._tick = logged_tick
    ctl.attach()
    sim.run_closed_loop(threads_per_client=20, ops_per_client=200,
                        workload_kw=_WL)
    return sim, ctl, ticks


@pytest.mark.parametrize("engine", ["fast", "oracle"])
def test_controller_decisions_match_reference(engine):
    ref, ref_ctl, ref_ticks = _controlled_run(REF, engine)
    got, ctl, ticks = _controlled_run(PORT, engine)
    assert len(ticks) == 8
    assert ticks == ref_ticks
    assert ctl.events == ref_ctl.events
    kinds = {e[1] for e in ctl.events}
    assert "replicate" in kinds and "reweight" in kinds
    assert got.churn_events == ref.churn_events
    assert got.hot_stats == ref.hot_stats
    a, b = got.records.columns(), ref.records.columns()
    for k in b:
        assert a[k].tobytes() == b[k].tobytes(), k
    # the weights moved away from uniform
    assert any(w != 1.0 for w in ticks[-1][2].values())


def test_controller_skips_under_partition():
    sim = port_sim.SimEdgeKV(setting="edge", group_sizes=(3,) * 3, seed=0,
                             engine="oracle")
    ctl = port_rebalance.RebalanceController(sim, period=0.05, ticks=2)
    sim.partition_of = {"g0": 0, "g1": 0, "g2": 1}
    assert ctl._tick() is False
    assert ctl.events == [(sim.env.now, "skip", "partitioned")]
    assert not sim.hot_keys and not sim.churn_events
    sim.partition_of = None


def test_exports():
    assert port_fault.FailureCoordinator.__module__ == \
        "repro_torch.fault.recovery"
    for name in ("Scenario", "Partition", "RegionalFailure", "FlashCrowd",
                 "Diurnal"):
        assert getattr(port_sim, name).__module__ == \
            "repro_torch.sim.scenario"
        assert name in port_sim.__all__
    assert {"FailureCoordinator", "RecoveryEvent"} <= \
        set(port_fault.__all__)
    assert np.isfinite(port_fault.detection_delay(5e-3, 8.0))

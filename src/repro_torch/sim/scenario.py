"""Composable, seeded scenario layer over
:class:`~repro_torch.sim.cluster.SimEdgeKV`.

A :class:`Scenario` is a declarative spec — a named tuple of event
dataclasses — compiled onto either engine:

* :class:`Partition` — a cut over the Table-3 link matrix with heal/merge
  semantics: both sides' phi-accrual detectors suspect each other
  (:func:`repro_torch.fault.detector.mutual_suspicion` over the outage
  windows this spec implies), Raft groups whose replica majority spans the cut
  refuse writes, and minority-side gateways return unavailability instead
  of stale acks. Ownership never moves during the cut, so the heal is a
  pure merge: stabilization replay is a no-op, deferred cross-cut leases
  resume, no key is resurrected or double-owned.
* :class:`RegionalFailure` — correlated loss of a whole region (several
  groups crash at the same instant), detection via the phi-accrual
  closed form, paced ring repair, mirror promotion, and (optionally) the
  recovered gateways re-joining under their *old* identities
  (:meth:`~repro_torch.sim.cluster.SimEdgeKV.rejoin_group` — vnode
  positions are a pure hash of the gateway id, so the ranges come back
  exactly).
* :class:`FlashCrowd` — an arrival-rate surge on some (or all) client
  groups over a window.
* :class:`Diurnal` — diurnal load rotation: the traffic peak moves from
  region to region, one ``period`` at a time.

Fault-style events (Partition/RegionalFailure) become auxiliary
processes — plain Timeout-only generators, so the fast engine drives
them on its event heap exactly like churn/fault drivers. Load-shape
events (FlashCrowd/Diurnal) compile to piecewise-constant rate-multiplier
profiles consumed by ``run_open_loop(rate_profiles=...)`` on both
engines. Everything is a pure function of the spec and the sim seed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Generator, List, Optional, Tuple, Union

from .cluster import SimEdgeKV
from .events import Timeout


@dataclass(frozen=True)
class Partition:
    """Network cut at ``t_start`` for ``duration`` seconds: groups in
    ``side`` land on side 1 of the cut, everyone else on side 0;
    ``straddle`` entries ``(gid, k)`` place ``k`` of that group's
    replicas on side 1 (its quorum side — if any — decides which clients
    it can serve). Healed by a pure merge (see module docstring)."""
    t_start: float
    duration: float
    side: Tuple[str, ...]
    straddle: Tuple[Tuple[str, int], ...] = ()


@dataclass(frozen=True)
class RegionalFailure:
    """Correlated regional failure: every group in ``gids`` crashes at
    ``t_start`` (one blast radius, not independent faults), is detected
    after the phi-accrual closed-form delay, then the ring repairs one
    ``stabilize_period`` per round and the §7.3 mirrors promote. With
    ``rejoin=True`` the recovered gateways re-enter the ring under their
    old identities ``rejoin_delay`` seconds after promotion."""
    t_start: float
    gids: Tuple[str, ...]
    heartbeat_period: float = 5e-3
    phi_threshold: float = 8.0
    stabilize_period: float = 0.02
    rejoin: bool = False
    rejoin_delay: float = 0.05


@dataclass(frozen=True)
class FlashCrowd:
    """Arrival surge: clients in ``gids`` (``None`` = all) multiply their
    Poisson rate by ``factor`` over ``[t_start, t_start + duration)``."""
    t_start: float
    duration: float
    factor: float
    gids: Optional[Tuple[str, ...]] = None


@dataclass(frozen=True)
class Diurnal:
    """Diurnal geo-rotation: the traffic peak visits one region per
    ``period``, cycling through ``order`` (``None`` = live groups in
    spawn order); the peaked region's rate is multiplied by ``factor``."""
    period: float
    factor: float
    order: Optional[Tuple[str, ...]] = None
    t_start: float = 0.0


Event = Union[Partition, RegionalFailure, FlashCrowd, Diurnal]


def partition_proc(sim: SimEdgeKV, spec: Partition) -> Generator:
    """Cut/heal driver (both engines: Timeout-only generator)."""
    yield Timeout(spec.t_start)
    sim.partition(list(spec.side), straddle=dict(spec.straddle))
    yield Timeout(spec.duration)
    sim.heal_partition()


def regional_failure_proc(sim: SimEdgeKV,
                          spec: RegionalFailure) -> Generator:
    """Correlated crash/recovery driver: the whole region goes dark at
    one instant; detection, paced stabilization, and mirror promotion
    follow the fault-driver timing model, and recovered gateways may
    re-join under their old identities."""
    from repro_torch.fault.detector import detection_delay
    yield Timeout(spec.t_start)
    for gid in spec.gids:
        sim.crash_group(gid)
    yield Timeout(detection_delay(spec.heartbeat_period,
                                  spec.phi_threshold))
    while not sim.ring.stabilized:
        sim.ring.stabilize()
        sim.ring.fix_fingers()
        sim._invalidate_gw_caches()
        yield Timeout(spec.stabilize_period)
    for gid in spec.gids:
        moved = sim.recover_group(gid)
        yield Timeout(sim.handoff_time(moved))
    if spec.rejoin:
        yield Timeout(spec.rejoin_delay)
        for gid in spec.gids:
            moved = sim.rejoin_group(gid)
            yield Timeout(sim.handoff_time(moved))


@dataclass(frozen=True)
class Scenario:
    """A named, declarative composition of scenario events.

    ``install(sim)`` registers the fault-style events as auxiliary
    processes (before ``run_*``); ``profiles(sim, duration)`` compiles
    the load-shape events into per-gid rate profiles for
    ``run_open_loop(rate_profiles=...)``. The two halves compose: a
    partition can cut the ring mid-surge.
    """
    name: str
    events: Tuple[Event, ...] = ()

    def install(self, sim: SimEdgeKV) -> None:
        for ev in self.events:
            if isinstance(ev, Partition):
                sim.env.process(partition_proc(sim, ev))
            elif isinstance(ev, RegionalFailure):
                sim.env.process(regional_failure_proc(sim, ev))

    def partition_windows(self) -> List[Tuple[float, float]]:
        """Planned ``(cut, heal)`` windows — e.g. heartbeat outage
        windows for :func:`repro_torch.fault.detector.mutual_suspicion`."""
        return [(ev.t_start, ev.t_start + ev.duration)
                for ev in self.events if isinstance(ev, Partition)]

    def rate_profile(self, gid: str, order: Tuple[str, ...],
                     duration: float
                     ) -> Optional[List[Tuple[float, float, float]]]:
        """Piecewise-constant rate-multiplier segments tiling
        ``[0, duration)`` for one client group: breakpoints at flash-
        crowd window edges and diurnal period boundaries, factor per
        segment = product of every matching event's factor. ``None``
        when the group's rate is flat (no event touches it)."""
        flash = [ev for ev in self.events if isinstance(ev, FlashCrowd)]
        diur = [ev for ev in self.events if isinstance(ev, Diurnal)]
        if not flash and not diur:
            return None
        cuts = {0.0, duration}
        for fc in flash:
            for t in (fc.t_start, fc.t_start + fc.duration):
                if 0.0 < t < duration:
                    cuts.add(t)
        for dv in diur:
            t = dv.t_start
            while t < duration:
                if t > 0.0:
                    cuts.add(t)
                t += dv.period
        bounds = sorted(cuts)
        segs: List[Tuple[float, float, float]] = []
        shaped = False
        for s0, s1 in zip(bounds[:-1], bounds[1:]):
            mid = 0.5 * (s0 + s1)
            f = 1.0
            for fc in flash:
                if fc.t_start <= mid < fc.t_start + fc.duration and \
                        (fc.gids is None or gid in fc.gids):
                    f *= fc.factor
            for dv in diur:
                cycle = dv.order or order
                if mid >= dv.t_start and cycle:
                    slot = int((mid - dv.t_start) // dv.period) % len(cycle)
                    if cycle[slot] == gid:
                        f *= dv.factor
            if f != 1.0:
                shaped = True
            segs.append((s0, s1, f))
        return segs if shaped else None

    def profiles(self, sim: SimEdgeKV, duration: float
                 ) -> Optional[Dict[str, List[Tuple[float, float, float]]]]:
        """Per-gid rate profiles over the sim's live groups, for
        ``run_open_loop(rate_profiles=...)``; ``None`` when no load-shape
        event is present (flat Poisson everywhere)."""
        live = tuple(gid for gid, g in sim.groups.items()
                     if not g["retired"])
        out = {}
        for gid in live:
            prof = self.rate_profile(gid, live, duration)
            if prof is not None:
                out[gid] = prof
        return out or None

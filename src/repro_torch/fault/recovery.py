"""Crash-recovery coordinator: detector-driven suspicion, Chord
stabilization rounds, and §7.3 backup promotion, in virtual time.

The mechanism pieces live where the state they touch lives —
``ChordRing.crash_node/stabilize/fix_fingers`` on the ring,
``EdgeKVCluster.crash_group/recover_group`` on the cluster, the
phi-accrual math in :mod:`repro_torch.fault.detector`. This module wires
them into the end-to-end pipeline an operator (or the failover example)
runs:

    heartbeats -> crash -> phi crosses threshold -> stabilize rounds ->
    fix_fingers -> promote mirrors -> timeline

Everything is virtual-time and seedable: the coordinator never reads the
wall clock, so recovery timelines are reproducible.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Optional, TYPE_CHECKING

from .detector import PhiAccrualDetector

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.kvstore import EdgeKVCluster


@dataclass
class RecoveryEvent:
    """One step of a recovery timeline (virtual seconds)."""
    t: float
    step: str      # heartbeat-warmup | crash | suspect | stabilize |
                   # fix-fingers | promote
    detail: str


class FailureCoordinator:
    """Drives unplanned-loss recovery for an :class:`EdgeKVCluster`.

    Gateways heartbeat every ``heartbeat_period`` seconds (with seeded
    jitter, so the detector sees a realistic inter-arrival distribution).
    After :meth:`crash`, :meth:`run_recovery` advances virtual time until
    the phi-accrual detector suspects the dead gateway, then runs
    stabilization and finger-repair rounds (one per ``stabilize_period``)
    until the ring is clean, and finally promotes the dead group's
    mirrors. The returned timeline is what experiments and the failover
    example report.
    """

    def __init__(self, cluster: "EdgeKVCluster", *,
                 heartbeat_period: float = 0.05, threshold: float = 8.0,
                 stabilize_period: float = 0.1, jitter: float = 0.1,
                 seed: int = 0):
        self.cluster = cluster
        self.detector = PhiAccrualDetector(threshold=threshold)
        self.heartbeat_period = heartbeat_period
        self.stabilize_period = stabilize_period
        self.jitter = jitter
        self.rng = random.Random(seed)
        self.now = 0.0
        self.timeline: List[RecoveryEvent] = []
        self._crashed: List[str] = []

    # ------------------------------------------------------------ plumbing
    def _log(self, step: str, detail: str) -> None:
        self.timeline.append(RecoveryEvent(self.now, step, detail))

    def _beat_all(self) -> None:
        for gw_id in self.cluster.gateways:
            # seeded jitter around the nominal period
            off = self.rng.uniform(-self.jitter, self.jitter)
            self.detector.heartbeat(gw_id,
                                    self.now + off * self.heartbeat_period)

    def warmup(self, beats: int = 20) -> None:
        """Observe ``beats`` heartbeat rounds so the detector has an
        inter-arrival estimate before any fault is injected."""
        for _ in range(beats):
            self._beat_all()
            self.now += self.heartbeat_period
        self._log("heartbeat-warmup",
                  f"{beats} rounds @ {1e3 * self.heartbeat_period:.0f} ms "
                  f"from {len(self.cluster.gateways)} gateways")

    # ------------------------------------------------------------ pipeline
    def crash(self, gid: str) -> None:
        """Unplanned loss of ``gid`` (its gateway stops heartbeating)."""
        gw_id = self.cluster.gateway_of_group[gid]
        self.cluster.crash_group(gid)
        self._crashed.append(gid)
        self._log("crash", f"{gid} ({gw_id}) lost — no drain, no goodbye; "
                  f"ring fingers now dangling: {not self.cluster.ring.stabilized}")

    def run_recovery(self) -> List[RecoveryEvent]:
        """Advance virtual time through detection, stabilization, and
        promotion for every crashed group; returns the timeline."""
        cluster = self.cluster
        # 1. detection: live gateways keep heartbeating; the dead one's
        #    phi accrues until it crosses the threshold
        dead_gws = [gw for gw in list(self.detector._last)
                    if gw not in cluster.gateways]
        for gw in dead_gws:
            delay = self.detector.detection_delay(gw)
            if delay is None:
                continue
            last = self.detector._last[gw]
            t_detect = last + delay
            while self.now < t_detect:
                self.now += self.heartbeat_period
                self._beat_all()
            self._log("suspect",
                      f"{gw}: phi={self.detector.phi(gw, self.now):.1f} >= "
                      f"{self.detector.threshold:.0f} "
                      f"({1e3 * delay:.0f} ms after last heartbeat)")
            self.detector.forget(gw)
        # 2. stabilization rounds until the ring is clean
        rounds = 0
        while not cluster.ring.stabilized:
            self.now += self.stabilize_period
            rounds += 1
            s = cluster.ring.stabilize()
            f = cluster.ring.fix_fingers()
            self._log("stabilize" if s else "fix-fingers",
                      f"round {rounds}: {s} successor entries, "
                      f"{f} fingers repaired")
        # 3. promotion of every pending mirror
        for gid in list(self._crashed):
            if gid not in cluster.dead_groups:
                continue  # already recovered elsewhere
            moved = cluster.recover_group(gid, stabilize=False)
            host = cluster.promoted_local.get(gid, "-")
            self._log("promote",
                      f"{gid}: {moved} global keys re-homed with the read "
                      f"barrier; local data adopted by {host}")
        self._crashed = [g for g in self._crashed
                         if g in cluster.dead_groups]
        return self.timeline

    # ------------------------------------------------------------- metrics
    def unavailability_window(self) -> Optional[float]:
        """Crash -> last promote, in virtual seconds (None before both)."""
        t_crash = [e.t for e in self.timeline if e.step == "crash"]
        t_prom = [e.t for e in self.timeline if e.step == "promote"]
        if not t_crash or not t_prom:
            return None
        return max(t_prom) - min(t_crash)

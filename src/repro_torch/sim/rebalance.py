"""Feedback-driven rebalancing: the closed control loop over §7.1
weighted consistent hashing and the §7.3 hot-key mirror machinery.

:class:`RebalanceController` runs as an auxiliary virtual-time process
on either engine. Each tick it

1. samples per-group throughput and latency tails from the *cached*
   ``RecordArray.group_stats`` aggregates (``sim.live_stats`` streams
   completed ops into the record array mid-run on the fast engine, so
   both engines observe the same feedback signal at the same virtual
   time),
2. detects hot keys — top-k by access count over the sliding window of
   ``sim.hot_track`` deltas since the previous tick — and installs
   bounded extra read replicas through ``replicate_hot_key`` (writes
   still linearize through the owner; a put revokes the mirror before
   acking), dropping replicas for keys that cooled off, and
3. re-weights the worst-deviating group's ring arc toward equalized
   *owner* load (mirror-served reads are excluded — they no longer land
   on the owner), actuating through ``sim.reweight_group(...,
   async_handoff=True)`` so moved keys migrate via the lease protocol
   and writes never stall behind the rebalance.

Weight targets are quantized (``quantum``) with a relative ``deadband``
so the two engines — which agree on op *order* but not bit-level
latencies under leases — always reach the same actuation decisions.
Determinism contract: no wall-clock, no RNG; every iteration order is
an insertion-ordered dict or explicitly sorted.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .events import Timeout


class RebalanceController:
    """Periodic feedback controller: sample -> detect -> actuate.

    Parameters
    ----------
    period:
        Virtual-time sampling interval between ticks.
    ticks:
        Number of control ticks (the aux process is finite, so
        ``env.run()`` still terminates when client traffic drains).
    top_k / hot_min_hits:
        A key is *hot* when it is among the ``top_k`` window counts and
        saw at least ``hot_min_hits`` accesses this window.
    gain:
        Exponent of the multiplicative weight update
        ``w * (ideal / share) ** gain`` — 1.0 jumps straight to the
        proportional target, smaller values converge gradually.
    deadband:
        Relative owner-load deviation below which no actuation happens
        (avoids weight thrash and keeps cross-engine decisions stable).
    quantum / min_weight / max_weight:
        Weight targets snap to ``quantum`` steps inside
        ``[min_weight, max_weight]``.
    min_window:
        Minimum non-mirrored accesses a window needs before the weight
        half may actuate — below it the per-group shares are sampling
        noise, and a noise-driven reweight pays real migration churn.
    lease_batch:
        Batch size for draining the handoff leases a reweight opens.
    """

    def __init__(self, sim, *, period: float = 0.1, ticks: int = 8,
                 top_k: int = 3, hot_min_hits: int = 4,
                 gain: float = 0.5, deadband: float = 0.15,
                 quantum: float = 0.25, min_weight: float = 0.25,
                 max_weight: float = 4.0, min_window: int = 50,
                 lease_batch: int = 64,
                 percentiles: Tuple[float, ...] = (95.0, 99.0)) -> None:
        self.sim = sim
        self.period = period
        self.ticks = ticks
        self.top_k = top_k
        self.hot_min_hits = hot_min_hits
        self.gain = gain
        self.deadband = deadband
        self.quantum = quantum
        self.min_weight = min_weight
        self.max_weight = max_weight
        self.min_window = min_window
        self.lease_batch = lease_batch
        self.percentiles = percentiles
        self._last_track: Dict[str, int] = {}
        #: (virtual time, action, detail) audit log of every decision
        self.events: List[tuple] = []
        #: last per-group (count, mean, *tails) feedback sample
        self.last_sample: Optional[dict] = None

    # ------------------------------------------------------------ wiring
    def attach(self) -> "RebalanceController":
        """Arm the feedback loop on ``self.sim`` and schedule the
        controller process. Must be called before the next ``run_*``."""
        self.sim.track_hot = True
        self.sim.live_stats = True
        # windows start from the *current* counters, so a controller
        # attached for a later phase never sees earlier phases' traffic
        self._last_track = dict(self.sim.hot_track)
        self.sim.env.process(self.proc())
        return self

    def proc(self):
        sim = self.sim
        for _ in range(self.ticks):
            yield Timeout(self.period)
            if self._tick():
                # actuated: drain the handoff leases in background
                # batches so the migration pays its transfer time here,
                # interleaved with (never stalling) client traffic
                yield from sim._drain_leases(self.lease_batch)

    # ------------------------------------------------------------ control
    def _window(self) -> Dict[str, int]:
        """Per-key access counts since the previous tick."""
        cur = dict(self.sim.hot_track)
        last = self._last_track
        self._last_track = cur
        return {k: d for k, c in cur.items()
                if (d := c - last.get(k, 0)) > 0}

    def _tick(self) -> bool:
        sim = self.sim
        now = sim.env.now
        if sim.partition_of:
            # no global view: neither replication seeds nor ring edits
            # are safe — hold every decision until the cut heals
            self.events.append((now, "skip", "partitioned"))
            return False
        # 1. feedback sample from the cached record aggregates
        self.last_sample = sim.records.group_stats(
            percentiles=self.percentiles)
        win = self._window()

        # 2. hot-key detection over the sliding window
        ranked = sorted(win.items(), key=lambda kv: (-kv[1], kv[0]))
        wanted = {k for k, c in ranked[:self.top_k]
                  if c >= self.hot_min_hits}
        for key in sorted(sim.hot_keys - wanted):
            sim.unreplicate_hot_key(key)
            self.events.append((now, "unreplicate", key))
        for key in sorted(wanted - sim.hot_keys):
            if sim.replicate_hot_key(key):
                self.events.append((now, "replicate", key))

        # 3. owner-load attribution and weight actuation
        load = {gid: 0 for gid, g in sim.groups.items()
                if not g["retired"]}
        for key, cnt in win.items():
            if key in sim.hot_keys:
                continue  # mirror-served: no longer owner load
            owner = sim.group_of_gateway[sim.ring.locate(key)]
            load[owner] = load.get(owner, 0) + cnt
        total = sum(load.values())
        if total < max(self.min_window, 1) or len(load) < 2:
            return False  # residual signal too thin to act on
        ideal = total / len(load)
        gid = max(load, key=lambda g: (abs(load[g] - ideal), g))
        share = load[gid]
        if abs(share - ideal) <= self.deadband * ideal:
            return False  # inside the deadband: converged enough
        gw = sim.gateway_of_group[gid]
        w = sim.ring.weights.get(gw, 1.0)
        target = w * (ideal / max(share, 1e-9)) ** self.gain
        new_w = round(target / self.quantum) * self.quantum
        new_w = min(max(new_w, self.min_weight), self.max_weight)
        if abs(new_w - w) < 1e-9:
            return False
        moved = sim.reweight_group(gid, new_w, async_handoff=True)
        self.events.append((now, "reweight", (gid, w, new_w, moved)))
        return moved > 0


__all__ = ["RebalanceController"]

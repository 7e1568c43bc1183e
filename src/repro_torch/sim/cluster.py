"""Virtual-time emulation of the paper's Grid'5000/Distem testbed (§5.3).

Topology (paper Fig. 4): three edge groups x three storage nodes, one
gateway per group on a Chord ring, one client per group running 100
closed-loop YCSB worker threads. Links follow Table 3 exactly
(:mod:`repro_torch.sim.network`); DHT routing uses the *real*
:class:`repro_torch.core.hashring.ChordRing`; committed operations apply to real
:class:`repro_torch.core.kvstore.StorageModule` state machines.

Timing model of the replication manager (etcd/Raft, §5.4.1):

* **write**: client -> contacted edge node (-> leader if not leader) ->
  leader's serialized commit stage (fsync pipeline, FIFO
  :class:`~repro_torch.sim.events.Resource`) -> parallel AppendEntries to
  followers, commit at the majority-th ack -> response to client.
* **linearizable read**: leader ReadIndex — a heartbeat quorum round, no
  disk append — then answer from the leader state machine.
* **global ops** additionally pay st-gw, Chord gw-gw hops (real finger-table
  path), and the remote group's quorum.

The only free parameter the paper doesn't pin down is the leader's per-op
service time (their disks); see DESIGN.md §2 'Calibration note'.

Two execution engines drive the same timing model:

* ``engine="oracle"`` (default) — one Python generator per client thread
  stepped by the discrete-event heap in :mod:`repro_torch.sim.events`. Simple,
  and the semantic ground truth.
* ``engine="fast"`` — the vectorized backend in
  :mod:`repro_torch.sim.vectorized`: batched numpy op schedules and delay
  columns, with only the true serialization points (leader commit stage,
  page-cache sequence) resolved by a per-group max-plus scan
  (:mod:`repro_torch.kernels.maxplus_scan`). Reproduces the oracle trace
  bit-for-bit on closed-loop runs without churn, and statistically on
  open-loop/churn runs (open loop + churn segments routing at
  membership events).

For whole parameter grids, :func:`repro_torch.sim.sweep.run_sweep` compiles N
open-loop fast-engine configurations into one jitted JAX array program
(each grid point matches ``engine="fast"`` on the same seeds).

Both engines draw their closed-loop op schedules from
:meth:`YCSBWorkload.batch_ops` with one numpy stream per client thread, so
the op sequence is a pure function of the seeds — independent of event
interleaving.
"""
from __future__ import annotations

import random
import zlib
from dataclasses import dataclass, field
from typing import (Any, Dict, Generator, List, Optional, Sequence, Set,
                    Tuple)

import numpy as np

from repro_torch.core.hashring import ChordRing
from repro_torch.core.kvstore import StorageModule, LOCAL, GLOBAL
from repro_torch.obs.trace import (B_END, B_INGRESS, B_LEASE, B_QUEUE, B_REPLICATE,
                             B_REQUEST, B_ROUTE, B_SERVICE, fill_bounds)

from .events import DeferredEnvironment, Environment, Resource, Timeout
from .records import OpRecord, RecordArray
from .network import NetworkModel, SETTINGS
from .ycsb import (Op, YCSBWorkload, DTYPE_CODE, DTYPES, KIND_CODE, KINDS,
                   RECORD_BYTES, REQ_BYTES)

ACK_BYTES = 64
ERR_BYTES = REQ_BYTES  # refusal/error ack frame (header-only response)
_NAN = float("nan")    # unsampled stage-boundary sentinel (tracing)


def arrival_seed(sim_seed: int, gid: str) -> int:
    """Process-stable open-loop arrival seed: crc32(gid) mixed with the
    sim seed (``hash(gid)`` is salted per process, which broke replay).
    Module-level so the sweep engine draws identical streams without a
    :class:`SimEdgeKV` instance."""
    return zlib.crc32(gid.encode()) ^ ((sim_seed + 1) * 0x9E3779B9
                                       & 0xFFFFFFFF)


@dataclass
class ServiceParams:
    """Host-side processing times (seconds). ``commit_s`` is the calibrated
    etcd leader commit stage — the single free parameter (the paper doesn't
    publish its disks' service time). 0.9 ms/op lands the 50%-global
    edge-vs-cloud comparison on the paper's 26%/19% numbers; see
    EXPERIMENTS.md §Repro for the full sensitivity sweep."""
    commit_s: float = 0.30e-3
    follower_append_s: float = 0.8e-3
    read_s: float = 0.2e-3
    gw_route_s: float = 0.2e-3
    # Storage-medium locality: touching a key outside the group's page
    # cache pays a cold-page penalty (the testbed nodes use HDDs; boltdb
    # pages for recently-touched keys sit in the OS page cache). This is
    # what differentiates the uniform/zipfian/latest distributions (Fig 7/8)
    # — Raft itself is key-agnostic.
    seek_s: float = 0.5e-3
    page_cache_keys: int = 2500  # 25% of the 10k-record YCSB keyspace


@dataclass
class ThreadPlan:
    """One closed-loop worker thread's pre-generated op schedule."""
    gid: str
    wl: YCSBWorkload
    key_idx: np.ndarray   # int64 index into wl.keys
    kind: np.ndarray      # uint8 KIND_CODE
    dtype: np.ndarray     # uint8 DTYPE_CODE
    fwd: np.ndarray       # bool: contacted edge node is not the leader


def closed_loop_plan(clients: Sequence[Tuple[int, str, int]],
                     threads_per_client: int, ops_per_client: int,
                     workload_kw: dict, seed_offset: int,
                     ) -> List[ThreadPlan]:
    """Pre-generate every worker thread's op schedule in bulk.

    ``clients`` rows are ``(gi, gid, n)`` — the group's *spawn index*
    (seeds are a function of spawn order), id, and replication size.
    One numpy stream per group, drawn in a single ``batch_ops`` call and
    sliced per thread — the schedule is a pure function of the seeds
    (never of event interleaving).  Module-level so the closed-loop
    sweep engine draws streams identical to a :class:`SimEdgeKV` run
    without instantiating one; the workload's seed-derived state
    (keyspace strings, hotset permutation, zipf CDF) is memoized inside
    :mod:`repro_torch.sim.ycsb` and shared across every caller.
    """
    plan: List[ThreadPlan] = []
    per_thread = max(1, ops_per_client // threads_per_client)
    total = per_thread * threads_per_client
    for gi, gid, n in clients:
        wl_seed = 1000 + gi + seed_offset
        wl = YCSBWorkload(seed=wl_seed, **workload_kw)
        fwd_p = (n - 1) / n
        rng = np.random.default_rng(
            np.random.SeedSequence([wl_seed & 0xFFFFFFFF]))
        key_idx, kind, dtype = wl.batch_ops(total, rng)
        fwd = ((dtype == DTYPE_CODE["local"])
               & (rng.random(total) < fwd_p))
        for t in range(threads_per_client):
            s = slice(t * per_thread, (t + 1) * per_thread)
            plan.append(ThreadPlan(gid, wl, key_idx[s], kind[s],
                                   dtype[s], fwd[s]))
    return plan


class SimEdgeKV:
    def __init__(
        self,
        *,
        setting: str = "edge",
        group_sizes: Tuple[int, ...] = (3, 3, 3),
        service: Optional[ServiceParams] = None,
        seed: int = 0,
        virtual_nodes: int = 1,
        gateway_cache: int = 0,
        engine: str = "oracle",
        successors: int = 4,
        trace: bool = False,
    ):
        if engine not in ("oracle", "fast"):
            raise ValueError(f"unknown engine {engine!r}")
        self.engine = engine
        # span tracing (repro_torch.obs): when on, every record carries the 8
        # absolute stage-end timestamps. The oracle samples env.now
        # between its existing event yields (never adding events, so
        # traced runs stay bit-identical); the fast engine reconstructs
        # the same boundaries from its delay columns.
        self.trace = trace
        # the fast engine drives auxiliary processes (e.g. churn_proc)
        # itself, so env.process must defer instead of scheduling
        self.env = DeferredEnvironment() if engine == "fast" else Environment()
        self.net: NetworkModel = SETTINGS[setting]
        self.setting = setting
        self.service = service or ServiceParams()
        self.seed = seed
        self.rng = random.Random(seed)
        self.ring = ChordRing(virtual_nodes=virtual_nodes,
                              successors=successors)
        self.groups: Dict[str, dict] = {}
        self.gateway_of_group: Dict[str, str] = {}
        self.group_of_gateway: Dict[str, str] = {}
        self._gateway_cache = gateway_cache
        self._next_gi = 0
        self.records = RecordArray(stages=trace)
        for n in group_sizes:
            self._spawn_group(n)
        self.client_spans: Dict[str, List[float]] = {}
        self.client_ops: Dict[str, int] = {}
        self.client_groups: Set[str] = set()  # groups hosting load generators
        # churn log: (virtual time, "add"|"remove"|"crash"|"recover", gid,
        # keys moved)
        self.churn_events: List[Tuple[float, str, str, int]] = []
        self.churn_epoch = 0  # bumped on every membership event
        # fault bookkeeping: global keys owned by a crashed group and not
        # yet recovered or re-written (key -> dead gid). Shared by both
        # engines; mutated in place so the fast engine can hold the ref.
        self.unavailable: Dict[str, str] = {}
        self.lost_ops = 0  # reads served while their key was unavailable
        # network partition (scenario layer): gid -> side (0/1) while a
        # cut over the Table-3 link matrix is active ({} = whole view).
        # A partition gates *availability only* — no promotion, no route
        # change, no churn event: both sides refuse ops whose authority
        # sits across the cut (or straddles it with no quorum side)
        # instead of acking stale, so heal is a pure merge by
        # construction (no double-owner possible). Shared by both
        # engines; mutated in place.
        self.partition_of: Dict[str, int] = {}
        self.partition_straddle: Dict[str, int] = {}  # gid -> replicas on side 1
        self.partition_minority = 1
        self.partition_events: List[Tuple[float, str]] = []
        self.refusals = dict(writes=0, reads=0, cross_cut=0, no_quorum=0,
                             minority_side=0, majority_side=0)
        # async handoff: per-key migration leases, key -> [src_gid,
        # dst_gid, dirty]. A leased key's destination is authoritative
        # from acquisition on; the value moves when a background release
        # batch (or a read, pulling on demand) resolves the lease. Shared
        # by both engines; mutated in place.
        self.leases: Dict[str, list] = {}
        self.handoff_stats = dict(leased=0, pulled=0, released=0,
                                  redirects=0, superseded=0)
        # ------- hot-key mirrors + feedback rebalancing -------
        # keys currently served by a bounded extra read replica at the
        # client's own gateway (§7.3 mirror machinery repurposed for
        # skew). A global WRITE revokes the key's entry at its
        # gateway-admit instant — before any routing — so a mirror read
        # can never serve a superseded value; with no deletes in the YCSB
        # op mix the virtual replica therefore always equals the owner
        # copy, and a crash cannot strand it (the mirror survives as the
        # extra copy, exactly the §7.3 read-only failover semantics).
        # Shared by both engines; mutated in place.
        self.hot_keys: Set[str] = set()
        self.hot_key_limit = 16
        self.hot_stats = dict(installed=0, dropped=0, invalidated=0,
                              mirror_reads=0)
        # per-key global-op dispatch counts sampled at the gateway-admit
        # instant in BOTH engines (the controller's sliding-window hot-key
        # signal); tracking is off unless a RebalanceController arms it
        self.track_hot = False
        self.hot_track: Dict[str, int] = {}
        # fast engine: flush completed op records at aux-event boundaries
        # so a controller sampling group_stats mid-run sees the same
        # completed-op prefix the oracle's append-at-completion stream
        # shows (armed together with track_hot)
        self.live_stats = False
        # §7.2 gateway location cache (beyond-paper evaluation: the paper
        # proposes it as future work; we measure it)
        self.gw_cache: Dict[str, Any] = {}
        if gateway_cache:
            from repro_torch.core.cache import LRUCache
            self.gw_cache = {gw: LRUCache(gateway_cache)
                             for gw in self.group_of_gateway}

    def _spawn_group(self, n: int) -> Tuple[str, str]:
        from repro_torch.core.cache import LRUCache
        gi = self._next_gi
        self._next_gi += 1
        gid, gw = f"g{gi}", f"gw{gi}"
        self.groups[gid] = {
            "n": n,
            "leader": Resource(self.env, capacity=1),
            "state": StorageModule(),
            "page_cache": LRUCache(max(1, self.service.page_cache_keys)),
            "retired": False,
            "crashed": False,
        }
        self.records.register_group(gid)
        self.ring.add_node(gw)
        self.gateway_of_group[gid] = gw
        self.group_of_gateway[gw] = gid
        return gid, gw

    # --------------------------------------------------------- elastic churn
    def add_group(self, n: int = 3, *,
                  async_handoff: bool = False) -> Tuple[str, int]:
        """Join an elastic group mid-run; returns (gid, global keys moved).

        The gateway enters the ring immediately (incremental finger update);
        global state whose successor changed is handed to the new group's
        state machine. In-flight ops that already resolved an owner complete
        against it — exactly the window the core-layer read barrier covers.

        With ``async_handoff=True`` the moving keys are *leased* to the new
        group instead of transferred at the event: values stay at their
        sources until :meth:`release_leases` (or a read pulling its key on
        demand) resolves each lease — the count returned is keys leased.

        Planned membership events serialize behind an in-flight handoff
        (core-layer rule): leases still pending from an earlier event are
        released first, so a lease's destination can never go stale.
        """
        self._require_whole_view("membership change (add_group)")
        if self.leases:
            self.release_leases()
        gid, gw = self._spawn_group(n)
        if self.gw_cache:
            from repro_torch.core.cache import LRUCache
            self.gw_cache[gw] = LRUCache(self._gateway_cache)
        self._invalidate_gw_caches()
        moved = 0
        dest = self.groups[gid]["state"]
        for other, g in self.groups.items():
            if other == gid or g["retired"]:
                continue
            store = g["state"].stores[GLOBAL]
            for key in [k for k in store if self.ring.locate(k) == gw]:
                if async_handoff:
                    if key not in self.leases:
                        self.leases[key] = [other, gid, False]
                        self.handoff_stats["leased"] += 1
                        moved += 1
                    continue
                dest.apply(("put", GLOBAL, key, store[key]))
                g["state"].apply(("delete", GLOBAL, key, None))
                moved += 1
        self.churn_events.append((self.env.now, "add", gid, moved))
        return gid, moved

    def remove_group(self, gid: str, *, async_handoff: bool = False) -> int:
        """Drain an elastic group mid-run; returns global keys moved.

        The group is *retired*, not deleted: its gateway leaves the ring so
        no new op routes to it, while ops already in flight finish against
        it for timing purposes (its global store is emptied by the drain;
        in-flight writes re-home at apply time, see _group_write). Groups
        hosting load-generating clients cannot be drained — their workers
        would lose their local store.

        With ``async_handoff=True`` the drain is incremental: every owned
        key is leased to its new ring owner and the store empties as the
        leases resolve (:meth:`release_leases`); returns keys leased.
        """
        self._require_whole_view("membership change (remove_group)")
        g = self.groups[gid]
        if g["retired"]:
            raise ValueError(f"{gid} already retired")
        if gid in self.client_groups:
            raise ValueError(f"cannot drain {gid}: load-generating clients attached")
        if len(self.ring) < 2:
            raise RuntimeError("cannot remove the last group")
        if self.leases:
            self.release_leases()  # serialize behind an in-flight handoff
        gw = self.gateway_of_group[gid]
        self.ring.remove_node(gw)
        g["retired"] = True
        self.gw_cache.pop(gw, None)
        self._invalidate_gw_caches()
        moved = 0
        store = g["state"].stores[GLOBAL]
        for key in list(store):
            owner_gid = self.group_of_gateway[self.ring.locate(key)]
            if async_handoff:
                if key not in self.leases:
                    self.leases[key] = [gid, owner_gid, False]
                    self.handoff_stats["leased"] += 1
                    moved += 1
                continue
            self.groups[owner_gid]["state"].apply(
                ("put", GLOBAL, key, store[key]))
            moved += 1
        if not async_handoff:
            store.clear()
        self.churn_events.append((self.env.now, "remove", gid, moved))
        return moved

    def reweight_group(self, gid: str, weight: float, *,
                       async_handoff: bool = False) -> int:
        """Change a live group's §7.1 ring weight mid-run (the actuation
        half of the rebalance feedback loop); returns global keys moved.

        The vnode delta is incremental (:meth:`ChordRing.reweight_node`
        adds/removes only the suffix the new weight implies), and every
        global key whose successor changed — in either direction — is
        re-homed to its new owner. With ``async_handoff=True`` the moved
        keys are *leased* instead (writes never stall behind the
        rebalance; reads pull on demand), returning keys leased. Planned
        membership events serialize behind an in-flight handoff, as
        everywhere else.
        """
        self._require_whole_view("membership change (reweight_group)")
        g = self.groups[gid]
        if g["retired"]:
            raise ValueError(f"{gid} is retired")
        if self.leases:
            self.release_leases()  # serialize behind an in-flight handoff
        gw = self.gateway_of_group[gid]
        added, removed = self.ring.reweight_node(gw, weight)
        if not added and not removed:
            # same vnode count: no arc moved, no handoff, no epoch bump
            self.churn_events.append((self.env.now, "reweight", gid, 0))
            return 0
        self._invalidate_gw_caches()
        moved = 0
        for other, og in self.groups.items():
            if og["retired"]:
                continue
            store = og["state"].stores[GLOBAL]
            other_gw = self.gateway_of_group[other]
            for key in [k for k in store
                        if self.ring.locate(k) != other_gw]:
                owner_gid = self.group_of_gateway[self.ring.locate(key)]
                if async_handoff:
                    if key not in self.leases:
                        self.leases[key] = [other, owner_gid, False]
                        self.handoff_stats["leased"] += 1
                        moved += 1
                    continue
                self.groups[owner_gid]["state"].apply(
                    ("put", GLOBAL, key, store[key]))
                og["state"].apply(("delete", GLOBAL, key, None))
                moved += 1
        self.churn_events.append((self.env.now, "reweight", gid, moved))
        return moved

    def replicate_hot_key(self, key: str) -> bool:
        """Install the bounded extra read replica for a hot key (§7.3
        mirror machinery). Refusals — active cut, key mid-migration,
        replica budget exhausted — are non-mutating and return False."""
        if key in self.hot_keys:
            return True
        if self.partition_of:
            return False  # no global view: the seed copy may be stale
        if key in self.leases:
            return False  # authority is mid-flight
        if len(self.hot_keys) >= self.hot_key_limit:
            return False
        self.hot_keys.add(key)
        self.hot_stats["installed"] += 1
        return True

    def unreplicate_hot_key(self, key: str) -> bool:
        """Drop a hot-key replica (the key cooled off). Idempotent."""
        if key not in self.hot_keys:
            return False
        self.hot_keys.discard(key)
        self.hot_stats["dropped"] += 1
        return True

    def release_leases(self, max_keys: Optional[int] = None) -> int:
        """Resolve up to ``max_keys`` pending leases (all by default) in
        acquisition order — the background half of the async handoff. A
        *dirty* lease (a client wrote at the destination while the key was
        in flight) discards the stale source copy; a pending one moves the
        value source -> destination and revalidates it if it was
        unavailable. Returns the number of leases resolved."""
        n = 0
        for key in list(self.leases):
            if max_keys is not None and n >= max_keys:
                break
            if self.partition_of:
                lease = self.leases[key]
                ss, ds = self._group_side(lease[0]), self._group_side(lease[1])
                if ss is None or ds is None or ss != ds:
                    continue  # deferred: the value would cross the cut
            src, dst, dirty = self.leases.pop(key)
            sstore = self.groups[src]["state"].stores[GLOBAL]
            if dirty:
                sstore.pop(key, None)
                self.handoff_stats["superseded"] += 1
            else:
                val = sstore.pop(key, None)
                if val is not None:
                    self.groups[dst]["state"].stores[GLOBAL][key] = val
                self.unavailable.pop(key, None)
            self.handoff_stats["released"] += 1
            n += 1
        return n

    def _invalidate_gw_caches(self) -> None:
        self.churn_epoch += 1
        for cache in self.gw_cache.values():
            cache.invalidate()

    def handoff_time(self, moved: int) -> float:
        """Virtual-time cost of bulk key handoff: one gw-gw transfer of the
        migrated records (the per-key Raft commit overlaps with it)."""
        if moved <= 0:
            return 0.0
        return self.net.xfer("gw_gw", moved * (RECORD_BYTES + REQ_BYTES))

    def churn_proc(self, *, t_start: float = 0.1, period: float = 0.2,
                   adds: int = 2, group_size: int = 3,
                   remove_added: bool = True, async_handoff: bool = False,
                   lease_batch: int = 64,
                   lease_period: float = 0.0) -> Generator:
        """Gateway churn driver: join ``adds`` elastic groups one per
        ``period``, then (optionally) drain them again — each membership
        event pays its key-handoff transfer time before the next.

        With ``async_handoff=True`` each membership event *leases* its
        keys and the driver releases them in ``lease_batch``-sized
        background batches (one transfer time plus ``lease_period`` per
        batch — a paced background migration), interleaved with client
        traffic, instead of one atomic bulk transfer.
        """
        yield Timeout(t_start)
        added: List[str] = []
        for _ in range(adds):
            gid, moved = self.add_group(group_size,
                                        async_handoff=async_handoff)
            added.append(gid)
            if async_handoff:
                yield from self._drain_leases(lease_batch, lease_period)
                yield Timeout(period)
            else:
                yield Timeout(self.handoff_time(moved) + period)
        if remove_added:
            for gid in added:
                moved = self.remove_group(gid, async_handoff=async_handoff)
                if async_handoff:
                    yield from self._drain_leases(lease_batch, lease_period)
                    yield Timeout(period)
                else:
                    yield Timeout(self.handoff_time(moved) + period)

    def _drain_leases(self, batch: int, pause: float = 0.0) -> Generator:
        """Background lease resolution: release pending leases in batches,
        paying one bulk-transfer time (plus an optional pacing pause) per
        batch. Client reads may race this, pulling individual keys on
        demand first."""
        while self.leases:
            moved = self.release_leases(batch)
            if moved == 0:
                # every remaining lease is deferred across an active cut:
                # resolution resumes after heal_partition()
                break
            yield Timeout(self.handoff_time(moved) + pause)

    # ------------------------------------------------------ network partitions
    def _require_whole_view(self, what: str) -> None:
        if self.partition_of:
            raise RuntimeError(f"cluster is partitioned: {what} needs a "
                               "global view — heal the cut first")

    def partition(self, side: List[str], *,
                  straddle: Optional[Dict[str, int]] = None) -> None:
        """Cut the link matrix: groups in ``side`` land on side 1, every
        other live group on side 0. ``straddle`` places ``k`` of a group's
        ``n`` replicas on side 1 (its quorum side — if any — decides which
        clients it can serve; a 50/50 split serves neither). A partition
        gates availability only: no ownership moves, no churn event fires,
        and routes stay valid, so :meth:`heal_partition` is a pure merge.
        """
        if self.partition_of:
            raise RuntimeError("already partitioned — heal the cut first")
        cut = set(side)
        live = [gid for gid, g in self.groups.items() if not g["retired"]]
        unknown = cut - set(live)
        if unknown:
            raise ValueError(
                f"cannot cut unknown/retired groups: {sorted(unknown)}")
        for gid, k in (straddle or {}).items():
            if gid in cut:
                raise ValueError(f"straddled group {gid} cannot also be "
                                 "wholly on side 1")
            if gid not in self.groups or self.groups[gid]["retired"]:
                raise ValueError(f"cannot straddle unknown/retired {gid}")
            n = self.groups[gid]["n"]
            if not 0 < k < n:
                raise ValueError(f"straddle must split {gid} (0 < k < {n})")
        self.partition_of = {gid: 1 if gid in cut else 0 for gid in live}
        self.partition_straddle = dict(straddle or {})
        n1 = sum(self.partition_of.values())
        self.partition_minority = 1 if n1 * 2 <= len(self.partition_of) else 0
        self.partition_events.append((self.env.now, "cut"))

    def heal_partition(self) -> None:
        """Merge the two sides. Neither side promoted or stole ownership
        during the cut (writes refused instead of failing over), so the
        divergent views differ only in suspicion state: the stabilization
        replay below is a no-op by construction and deferred cross-cut
        leases simply resume draining."""
        if not self.partition_of:
            raise RuntimeError("not partitioned")
        self.partition_of = {}
        self.partition_straddle = {}
        while not self.ring.stabilized:  # pragma: no cover — no-op replay
            self.ring.stabilize()
            self.ring.fix_fingers()
        self.partition_events.append((self.env.now, "heal"))

    def _group_side(self, gid: str) -> Optional[int]:
        """Which side of the cut this group can commit quorums on.
        ``None`` = neither (a straddled group whose replica majority
        exists on no side — it must refuse every quorum op)."""
        k = self.partition_straddle.get(gid)
        if k is not None:
            n = self.groups[gid]["n"]
            if (n - k) * 2 > n:
                return 0
            if k * 2 > n:
                return 1
            return None
        return self.partition_of.get(gid, 0)

    # refusal codes: 0 allowed; 1 cross-cut (the key's authority sits on
    # the other side); 2 no-quorum (authority straddles the cut with no
    # replica majority on either side)
    def _refusal_code(self, client_gid: str, key: str,
                      is_write: bool) -> int:
        cs = self._group_side(client_gid)
        if cs is None:
            return 2
        lease = self.leases.get(key)
        if lease is not None:
            ds = self._group_side(lease[1])
            if ds is None:
                return 2
            if ds != cs:
                return 1
            if not is_write and not lease[2]:
                # a clean lease's value still sits at the source: the
                # pull-on-demand read would have to cross the cut
                ss = self._group_side(lease[0])
                if ss is None:
                    return 2
                if ss != cs:
                    return 1
            return 0
        owner_side = self._group_side(
            self.group_of_gateway[self.ring.locate(key)])
        if owner_side is None:
            return 2
        return 0 if owner_side == cs else 1

    def _count_refusal(self, client_gid: str, is_write: bool,
                       code: int) -> None:
        self.refusals["writes" if is_write else "reads"] += 1
        self.refusals["cross_cut" if code == 1 else "no_quorum"] += 1
        minority = (self.partition_of.get(client_gid, 0)
                    == self.partition_minority)
        self.refusals["minority_side" if minority else "majority_side"] += 1

    # -------------------------------------------------------- fault injection
    def crash_group(self, gid: str) -> int:
        """Unplanned loss of a group mid-run — no drain, no goodbye.

        Unlike :meth:`remove_group`, the group's global state is NOT
        migrated: its keys become *unavailable* (reads targeting them are
        counted as lost ops) until :meth:`recover_group` promotes the
        §7.3 mirror or a client re-writes them at the new owner. The
        gateway leaves the ring abruptly (:meth:`ChordRing.crash_node`):
        ownership transfers to the successors immediately, but fingers
        keep dangling references — routes taken before stabilization may
        pay extra hops, exactly the window the failover experiment
        measures. Returns the number of keys made unavailable.
        """
        self._require_whole_view("membership change (crash_group)")
        g = self.groups[gid]
        if g["retired"]:
            raise ValueError(f"{gid} already retired")
        if gid in self.client_groups:
            raise ValueError(
                f"cannot crash {gid}: load-generating clients attached")
        if len(self.ring) < 2:
            raise RuntimeError("cannot crash the last group")
        gw = self.gateway_of_group[gid]
        self.ring.crash_node(gw)  # raises before mutating on a fatal loss
        g["retired"] = True
        g["crashed"] = True
        self.gw_cache.pop(gw, None)
        self._invalidate_gw_caches()
        store = g["state"].stores[GLOBAL]
        if self.leases:
            # deterministic mid-migration resolution (mirrors the core
            # layer's crash fixups): a lease whose destination died either
            # re-targets (value still at the live source) or dies with the
            # destination's store; a lease whose source died leaves its
            # pending value in the crashed store (swept to `unavailable`
            # below) — except dirty leases, whose stale source copy is
            # dropped NOW so it can't be counted unavailable or promoted.
            for key, lease in list(self.leases.items()):
                src, dst, dirty = lease
                if dst == gid:
                    if dirty:
                        if not self.groups[src]["crashed"]:
                            self.groups[src]["state"].stores[GLOBAL].pop(
                                key, None)
                        del self.leases[key]
                        self.handoff_stats["released"] += 1
                    else:
                        new_owner = self.group_of_gateway[
                            self.ring.locate(key)]
                        if new_owner == src:
                            del self.leases[key]
                            self.handoff_stats["released"] += 1
                        else:
                            lease[1] = new_owner
                elif src == gid:
                    if dirty:
                        store.pop(key, None)  # dst holds the fresh value
                    del self.leases[key]
                    self.handoff_stats["released"] += 1
        for key in store:
            self.unavailable[key] = gid
        self.churn_events.append((self.env.now, "crash", gid, len(store)))
        return len(store)

    def recover_group(self, gid: str, *, async_handoff: bool = False) -> int:
        """Backup-group promotion of a crashed group's surviving mirror:
        its global keys re-home to their current ring owners (modeling
        the §7.3 learner-mirror handoff), except keys a client already
        re-wrote at the new owner — those are newer and win. Finishes the
        ring repair (stabilize + fix_fingers until clean). Returns the
        number of promoted keys.

        With ``async_handoff=True`` the surviving keys are *leased* to
        their ring owners instead of bulk-promoted: a read pulls its key
        on demand (ending that key's unavailability early), the rest
        drain via :meth:`release_leases` — returns keys leased."""
        self._require_whole_view("membership change (recover_group)")
        g = self.groups[gid]
        if not g["crashed"]:
            raise ValueError(f"{gid} is not a crashed group")
        if self.leases:
            self.release_leases()  # serialize behind an in-flight handoff
        moved = 0
        store = g["state"].stores[GLOBAL]
        for key in list(store):
            if key not in self.unavailable:
                if key not in self.leases:
                    store.pop(key)  # re-written at the live owner: stale
                continue
            owner_gid = self.group_of_gateway[self.ring.locate(key)]
            if async_handoff:
                if key not in self.leases:
                    self.leases[key] = [gid, owner_gid, False]
                    self.handoff_stats["leased"] += 1
                    moved += 1
                continue
            self.unavailable.pop(key, None)
            self.groups[owner_gid]["state"].apply(
                ("put", GLOBAL, key, store[key]))
            store.pop(key)
            moved += 1
        g["crashed"] = False  # recovered (still retired: hosts are gone)
        while not self.ring.stabilized:
            self.ring.stabilize()
            self.ring.fix_fingers()
        # routes shorten after the repair: force both engines to re-resolve
        self._invalidate_gw_caches()
        self.churn_events.append((self.env.now, "recover", gid, moved))
        return moved

    def rejoin_group(self, gid: str) -> int:
        """Re-join a recovered group under its OLD identity. Gateway vnode
        positions are a pure hash of the gateway id
        (:func:`repro_torch.core.hashring.stable_hash`), so re-adding ``gw``
        reclaims exactly the ring ranges it owned before the crash — the
        returning node is not a fresh identity and causes no second
        reshuffle. Global keys locating to the returning gateway are
        pulled back from their interim owners; returns keys moved."""
        self._require_whole_view("membership change (rejoin_group)")
        g = self.groups[gid]
        if not g["retired"] or g["crashed"]:
            raise ValueError(f"{gid} is not a recovered (retired) group")
        if self.leases:
            self.release_leases()  # serialize behind an in-flight handoff
        gw = self.gateway_of_group[gid]
        self.ring.add_node(gw)
        g["retired"] = False
        if self._gateway_cache:
            from repro_torch.core.cache import LRUCache
            self.gw_cache[gw] = LRUCache(self._gateway_cache)
        self._invalidate_gw_caches()
        moved = 0
        dest = g["state"]
        for other, og in self.groups.items():
            if other == gid or og["retired"]:
                continue
            store = og["state"].stores[GLOBAL]
            for key in [k for k in store if self.ring.locate(k) == gw]:
                dest.apply(("put", GLOBAL, key, store[key]))
                og["state"].apply(("delete", GLOBAL, key, None))
                moved += 1
        self.churn_events.append((self.env.now, "rejoin", gid, moved))
        return moved

    @property
    def fault_events(self) -> List[Tuple[float, str, str, int]]:
        """Crash/recover entries of the churn log."""
        return [ev for ev in self.churn_events if ev[1] in ("crash",
                                                            "recover")]

    def heartbeat_arrivals(self, *, duration: float, period: float = 0.05,
                           jitter: float = 0.1, payload: int = 64,
                           observer: Optional[str] = None,
                           until: Optional[Dict[str, float]] = None,
                           outages: Optional[Dict[str, List[Tuple[float,
                                                                  float]]]]
                           = None,
                           ) -> Dict[str, np.ndarray]:
        """Seeded heartbeat arrival streams as a monitor gateway observes
        them over this setting's gw-gw link (Table 3).

        Each live gateway emits a heartbeat every ``period`` seconds with
        seeded uniform send jitter of ``±jitter * period`` (one numpy
        stream per gateway, a pure function of the sim seed); every beat
        then pays the deterministic Table-3 gw-gw transfer of a
        ``payload``-byte frame before the observer sees it. ``until`` cuts
        a gateway's stream at its crash instant (beats sent after it are
        never observed); ``outages`` drops beats whose send time falls in
        any ``(t0, t1)`` window for that gateway — the cross-cut silence a
        network partition imposes on the observer's view of the far side
        (symmetric suspicion: build both directions' streams with the same
        windows). This is the traffic a :class:`PhiAccrualDetector`
        at ``observer`` consumes — the detector-from-traffic harness the
        fault tests drive (false-positive bounds over real inter-arrival
        noise instead of the closed-form delay).
        """
        if not 0.0 <= jitter < 0.5:
            raise ValueError("jitter must be in [0, 0.5) to keep heartbeat"
                             " send times monotone")
        delay = self.net.xfer("gw_gw", payload)
        out: Dict[str, np.ndarray] = {}
        for gw in self.group_of_gateway:
            if gw == observer:
                continue
            rng = np.random.default_rng(np.random.SeedSequence(
                [zlib.crc32(gw.encode()) & 0xFFFFFFFF,
                 (self.seed + 1) & 0xFFFFFFFF, 0x48B]))
            n = int(np.floor(duration / period)) + 1
            send = (np.arange(n) * period
                    + rng.uniform(-jitter, jitter, n) * period)
            cut = (until or {}).get(gw)
            if cut is not None:
                send = send[send <= cut]
            for w0, w1 in (outages or {}).get(gw, []):
                send = send[(send < w0) | (send >= w1)]
            out[gw] = np.sort(send) + delay
        return out

    def fault_proc(self, *, victims: Tuple[str, ...], t_crash: float = 0.1,
                   heartbeat_period: float = 5e-3,
                   phi_threshold: float = 8.0,
                   stabilize_period: float = 0.02,
                   gap: float = 0.1, async_handoff: bool = False,
                   lease_batch: int = 64,
                   lease_period: float = 0.0) -> Generator:
        """Crash/recovery schedule driver (both engines).

        Each victim crashes, stays dark for the phi-accrual detection
        delay (closed form from :mod:`repro_torch.fault.detector` — the last
        heartbeat precedes the crash, so this is the detector's whole
        contribution to the unavailability window), then pays one
        ``stabilize_period`` per stabilization round until the ring is
        clean, promotes the mirror, and pays the bulk-handoff transfer
        for the promoted keys. With ``async_handoff=True`` promotion is
        leased instead of bulk: reads pull their keys on demand (per-key
        unavailability ends early) while the driver drains the rest in
        ``lease_batch``-sized background batches.
        """
        from repro_torch.fault.detector import detection_delay
        yield Timeout(t_crash)
        for gid in victims:
            self.crash_group(gid)
            yield Timeout(detection_delay(heartbeat_period, phi_threshold))
            # periodic repair: one round per period until the ring is
            # clean; recover_group finishes any remainder synchronously
            while not self.ring.stabilized:
                self.ring.stabilize()
                self.ring.fix_fingers()
                # routes shorten as fingers heal: both engines re-resolve
                self._invalidate_gw_caches()
                yield Timeout(stabilize_period)
            moved = self.recover_group(gid, async_handoff=async_handoff)
            if async_handoff:
                yield from self._drain_leases(lease_batch, lease_period)
                yield Timeout(gap)
            else:
                yield Timeout(self.handoff_time(moved) + gap)

    # ------------------------------------------------------------ group ops
    def _quorum_rtt(self, n: int, payload: int) -> float:
        """Time from leader broadcast to the majority-th follower ack."""
        need = (n // 2 + 1) - 1  # followers needed beyond the leader itself
        if need <= 0:
            return 0.0
        rtts = sorted(
            self.net.xfer("st_st", payload)
            + self.service.follower_append_s
            + self.net.xfer("st_st", ACK_BYTES)
            for _ in range(n - 1)
        )
        return rtts[need - 1]

    def _page_penalty(self, g: dict, key: str) -> float:
        hit = g["page_cache"].get(key) is not None
        g["page_cache"].put(key, True)
        return 0.0 if hit else self.service.seek_s

    def _group_write(self, gid: str, op: Op, tier: str,
                     tb: Optional[List[float]] = None) -> Generator:
        g = self.groups[gid]
        yield g["leader"].acquire()
        if tb is not None:
            tb[B_QUEUE] = self.env.now          # queue wait ends here
        yield Timeout(self.service.commit_s + self._page_penalty(g, op.key))
        if tb is not None:
            tb[B_SERVICE] = self.env.now
        g["leader"].release()
        yield Timeout(self._quorum_rtt(g["n"], op.value_bytes + ACK_BYTES))
        if tb is not None:
            tb[B_REPLICATE] = self.env.now
        if tier == GLOBAL and self.churn_events:
            # a churn event (join OR drain) may have re-homed the key while
            # this op was in flight: the write follows the handoff to the
            # key's current owner (the core layer's read-barrier/forwarding
            # semantics), so state is never stranded at a stale owner.
            # Gated on churn_events to keep churn-free runs off this lookup.
            owner_gid = self.group_of_gateway[self.ring.locate(op.key)]
            if owner_gid != gid:
                gid, g = owner_gid, self.groups[owner_gid]
            if self.unavailable:
                # a fresh write at the live owner supersedes the crashed
                # copy: the key is available again (last write wins)
                self.unavailable.pop(op.key, None)
        g["state"].apply(("put", tier, op.key, ("v", op.value_bytes)))

    def _group_read(self, gid: str, op: Op, tier: str,
                    tb: Optional[List[float]] = None) -> Generator:
        g = self.groups[gid]
        yield g["leader"].acquire()
        if tb is not None:
            tb[B_QUEUE] = self.env.now          # queue wait ends here
        yield Timeout(self.service.read_s + self._page_penalty(g, op.key))
        if tb is not None:
            tb[B_SERVICE] = self.env.now
        g["leader"].release()
        # ReadIndex heartbeat round (no disk append at followers)
        need = (g["n"] // 2 + 1) - 1
        if need > 0:
            yield Timeout(2 * self.net.xfer("st_st", ACK_BYTES))
        if tb is not None:
            tb[B_REPLICATE] = self.env.now
        if tier == GLOBAL and self.unavailable and op.key in self.unavailable:
            self.lost_ops += 1  # owner crashed, mirror not yet promoted
        g["state"].get(tier, op.key)

    # ------------------------------------------------------------ client op
    def _bounds(self, t0: float, tb: List[float]) -> List[float]:
        """Close a boundary list at op completion (records the end stamp
        and fills stages the op never entered)."""
        tb[B_END] = self.env.now
        return fill_bounds(t0, tb)

    def client_op(self, client_gid: str, op: Op) -> Generator:
        t0 = self.env.now
        # tracing samples env.now BETWEEN the existing yields — it never
        # adds or removes events, so traced runs replay bit-identically
        tb: Optional[List[float]] = [_NAN] * 8 if self.trace else None
        is_write = op.kind in ("update", "insert")
        req = REQ_BYTES + (op.value_bytes if is_write else 0)
        resp = REQ_BYTES + (0 if is_write else op.value_bytes)
        hops = 0

        yield Timeout(self.net.xfer("cli_st", req))

        if op.dtype == LOCAL:
            # contacted edge node forwards to the group leader unless it IS
            # the leader (Algorithm 1 line 6): probability (n-1)/n. Batched
            # schedules pre-draw the coin (op.fwd) per thread stream.
            if op.fwd is not None:
                fwd = op.fwd
            else:
                n = self.groups[client_gid]["n"]
                fwd = self.rng.random() < (n - 1) / n
            if fwd:
                yield Timeout(self.net.xfer("st_st", req))
            if tb is not None:
                tb[B_REQUEST] = self.env.now
            if self.partition_straddle and \
                    self._group_side(client_gid) is None:
                # straddled client group with no replica majority on
                # either side: every local quorum op (write commit or
                # ReadIndex round) refuses — counted, non-mutating
                self._count_refusal(client_gid, is_write, 2)
                if fwd:
                    yield Timeout(self.net.xfer("st_st", ERR_BYTES))
                yield Timeout(self.net.xfer("cli_st", ERR_BYTES))
                self.records.append(t0, self.env.now - t0,
                                    KIND_CODE[op.kind],
                                    DTYPE_CODE[op.dtype],
                                    self.records.group_code(client_gid), 0,
                                    bounds=(self._bounds(t0, tb)
                                            if tb is not None else None))
                return
            if is_write:
                yield from self._group_write(client_gid, op, LOCAL, tb)
            else:
                yield from self._group_read(client_gid, op, LOCAL, tb)
            if fwd:
                yield Timeout(self.net.xfer("st_st", resp))
        else:
            # global: edge node -> local gateway -> Chord -> owner group
            gw = self.gateway_of_group[client_gid]
            yield Timeout(self.net.xfer("st_gw", req))
            if tb is not None:
                tb[B_REQUEST] = self.env.now
            if self.partition_of:
                code = self._refusal_code(client_gid, op.key, is_write)
                if code:
                    # split-brain refusal at the gateway-lookup instant:
                    # the key's authority is across the cut (or has no
                    # quorum side) — error ack back, nothing mutates, no
                    # cache insert, no leader time
                    self._count_refusal(client_gid, is_write, code)
                    yield Timeout(self.net.xfer("st_gw", ERR_BYTES))
                    yield Timeout(self.net.xfer("cli_st", ERR_BYTES))
                    self.records.append(
                        t0, self.env.now - t0, KIND_CODE[op.kind],
                        DTYPE_CODE[op.dtype],
                        self.records.group_code(client_gid), 0,
                        bounds=(self._bounds(t0, tb)
                                if tb is not None else None))
                    return
            if self.track_hot:
                # controller feedback signal: per-key dispatch counts at
                # the gateway-admit instant (the fast engine counts at
                # the matching two-phase lookup event)
                self.hot_track[op.key] = self.hot_track.get(op.key, 0) + 1
            if self.hot_keys:
                if is_write:
                    if op.key in self.hot_keys:
                        # revoke-on-put (PR 5 discipline): the write still
                        # linearizes through the owner below; the mirror
                        # entry dies before the route is even resolved
                        self.hot_keys.discard(op.key)
                        self.hot_stats["invalidated"] += 1
                elif op.key in self.hot_keys:
                    # hot-key mirror read: served by the extra replica
                    # installed *at the client's own gateway* (the §7.3
                    # mirror machinery, matching the core layer's
                    # resource_get) — no Chord routing, no leader queue,
                    # no ReadIndex quorum round (serializable, like a
                    # backup read); the revoke-on-put above keeps the
                    # replica equal to the owner's committed copy
                    self.hot_stats["mirror_reads"] += 1
                    if tb is not None:
                        tb[B_QUEUE] = self.env.now
                    yield Timeout(self.service.read_s)
                    if tb is not None:
                        tb[B_SERVICE] = self.env.now
                    yield Timeout(self.net.xfer("st_gw", resp))
                    yield Timeout(self.net.xfer("cli_st", resp))
                    self.records.append(
                        t0, self.env.now - t0, KIND_CODE[op.kind],
                        DTYPE_CODE[op.dtype],
                        self.records.group_code(client_gid), 0,
                        bounds=(self._bounds(t0, tb)
                                if tb is not None else None))
                    return
            cached_owner = (self.gw_cache[gw].get(op.key)
                            if self.gw_cache else None)
            if cached_owner is not None:
                owner_gw = cached_owner
                hops = 0 if owner_gw == gw else 1  # direct hop, no lookup
                if hops:
                    yield Timeout(self.net.xfer("gw_gw", req)
                                  + self.service.gw_route_s)
            else:
                epoch = self.churn_epoch
                path = self.ring.route(gw, op.key)
                owner_gw = path[-1]
                hops = len(path) - 1
                for _ in range(hops):
                    yield Timeout(self.net.xfer("gw_gw", req)
                                  + self.service.gw_route_s)
                # don't re-insert a location learned before a churn event:
                # the invalidation already ran and this owner may be stale
                if self.gw_cache and epoch == self.churn_epoch:
                    self.gw_cache[gw].put(op.key, owner_gw)
            if tb is not None:
                tb[B_ROUTE] = self.env.now
            owner_gid = self.group_of_gateway[owner_gw]
            if self.leases:
                lease = self.leases.get(op.key)
                if lease is not None and owner_gid != lease[1]:
                    # stale route (op resolved its owner before the
                    # membership event): forward to the leaseholder —
                    # one extra overlay hop, the redirect/retry cost
                    # the async protocol pays instead of blocking
                    self.handoff_stats["redirects"] += 1
                    hops += 1
                    owner_gid = lease[1]
                    owner_gw = self.gateway_of_group[owner_gid]
                    yield Timeout(self.net.xfer("gw_gw", req)
                                  + self.service.gw_route_s)
                    # the lease may have resolved during the hop
                    lease = self.leases.get(op.key)
                if lease is not None:
                    if is_write:
                        lease[2] = True  # destination write supersedes src
                    elif not lease[2]:
                        # pull-on-demand: the read completes this key's
                        # migration (per-key read barrier) before serving.
                        # The lease is claimed BEFORE the transfer yields,
                        # so a concurrent reader can't double-pull it.
                        self.handoff_stats["pulled"] += 1
                        self.handoff_stats["released"] += 1
                        del self.leases[op.key]
                        src_store = self.groups[lease[0]]["state"] \
                            .stores[GLOBAL]
                        val = src_store.pop(op.key, None)
                        if val is not None:
                            self.groups[lease[1]]["state"] \
                                .stores[GLOBAL][op.key] = val
                        self.unavailable.pop(op.key, None)
                        yield Timeout(self.net.xfer(
                            "gw_gw", RECORD_BYTES + REQ_BYTES))
            if tb is not None:
                tb[B_LEASE] = self.env.now
            yield Timeout(self.net.xfer("st_gw", req))  # gw -> group leader
            if tb is not None:
                tb[B_INGRESS] = self.env.now
            if is_write:
                yield from self._group_write(owner_gid, op, GLOBAL, tb)
            else:
                yield from self._group_read(owner_gid, op, GLOBAL, tb)
            yield Timeout(self.net.xfer("st_gw", resp))  # leader -> owner gw
            if owner_gw != gw:
                yield Timeout(self.net.xfer("gw_gw", resp))  # direct return
            yield Timeout(self.net.xfer("st_gw", resp))  # gw -> edge node

        yield Timeout(self.net.xfer("cli_st", resp))
        self.records.append(t0, self.env.now - t0, KIND_CODE[op.kind],
                            DTYPE_CODE[op.dtype],
                            self.records.group_code(client_gid), hops,
                            bounds=(self._bounds(t0, tb)
                                    if tb is not None else None))

    # -------------------------------------------------------- load drivers
    def _closed_loop_plan(self, threads_per_client: int, ops_per_client: int,
                          workload_kw: dict, seed_offset: int,
                          client_groups: Optional[Tuple[str, ...]] = None,
                          ) -> List[ThreadPlan]:
        """Pre-generate every worker thread's op schedule in bulk.

        One numpy stream per group, drawn in a single ``batch_ops`` call
        and sliced per thread — the schedule is a pure function of the
        seeds (never of event interleaving), identical for both engines.
        ``client_groups`` restricts which groups host load generators
        (fault experiments keep crash victims client-free); group seeds
        stay a function of spawn order either way.  Plan generation
        itself lives in the module-level :func:`closed_loop_plan` shared
        with the sweep engine.
        """
        clients: List[Tuple[int, str, int]] = []
        per_thread = max(1, ops_per_client // threads_per_client)
        for gi, gid in enumerate(list(self.groups)):
            if self.groups[gid]["retired"]:
                continue
            if client_groups is not None and gid not in client_groups:
                continue
            clients.append((gi, gid, self.groups[gid]["n"]))
            self.client_ops[gid] = per_thread * threads_per_client
            self.client_groups.add(gid)
        return closed_loop_plan(clients, threads_per_client,
                                ops_per_client, workload_kw, seed_offset)

    def run_closed_loop(self, *, threads_per_client: int = 100,
                        ops_per_client: int = 10_000,
                        workload_kw: Optional[dict] = None,
                        seed_offset: int = 0,
                        client_groups: Optional[Tuple[str, ...]] = None,
                        ) -> None:
        """One client per group, each with N closed-loop worker threads
        sharing ``ops_per_client`` operations (the paper's YCSB setup).

        ``seed_offset`` shifts every client's workload seed uniformly (same
        offset => identical replay); the caller's ``workload_kw`` dict is
        never mutated. ``client_groups`` restricts which groups host load
        generators (default: every live group).
        """
        plan = self._closed_loop_plan(threads_per_client, ops_per_client,
                                      dict(workload_kw or {}), seed_offset,
                                      client_groups)
        if self.engine == "fast":
            from .vectorized import run_closed_loop_fast
            run_closed_loop_fast(self, plan)
        else:
            for tp in plan:
                self.env.process(self._worker(tp))
            self.env.run()
        # per-group spans fall out of the SoA buffer in a single pass
        for gid, (_, _, t_last) in self.records.group_stats().items():
            self.client_spans[gid] = [t_last]

    def _worker(self, tp: ThreadPlan) -> Generator:
        keys, kinds, dtypes = tp.wl.keys, tp.kind, tp.dtype
        for i in range(len(tp.key_idx)):
            op = Op(KINDS[kinds[i]], keys[tp.key_idx[i]], DTYPES[dtypes[i]],
                    fwd=bool(tp.fwd[i]))
            yield from self.client_op(tp.gid, op)

    def run_open_loop(self, *, rate_per_client: float, duration: float,
                      workload_kw: Optional[dict] = None,
                      client_groups: Optional[Tuple[str, ...]] = None,
                      rate_profiles: Optional[Dict[str, List[Tuple[
                          float, float, float]]]] = None,
                      ) -> None:
        """Poisson arrivals at ``rate_per_client`` ops/s per client (Fig 13).

        ``rate_profiles`` (scenario layer) maps a client gid to a list of
        piecewise-constant ``(t_start, t_end, factor)`` rate-multiplier
        segments relative to run start — flash-crowd surges and diurnal
        rotation modulate the Poisson rate per segment (``factor <= 0``
        silences the segment). Groups without a profile run flat.
        """
        workload_kw = dict(workload_kw or {})
        if self.engine == "fast":
            from .vectorized import run_open_loop_fast
            run_open_loop_fast(self, rate_per_client, duration, workload_kw,
                               client_groups, rate_profiles)
            return
        for gi, gid in enumerate(list(self.groups)):
            if self.groups[gid]["retired"]:
                continue
            if client_groups is not None and gid not in client_groups:
                continue
            wl = YCSBWorkload(seed=2000 + gi, **workload_kw)
            self.client_groups.add(gid)
            self.env.process(self._arrivals(
                gid, wl, rate_per_client, duration,
                (rate_profiles or {}).get(gid)))
        self.env.run()

    def _arrival_seed(self, gid: str) -> int:
        return arrival_seed(self.seed, gid)

    def _arrivals(self, gid: str, wl: YCSBWorkload, rate: float,
                  duration: float,
                  profile: Optional[List[Tuple[float, float, float]]] = None,
                  ) -> Generator:
        rng = random.Random(self._arrival_seed(gid))
        t_start = self.env.now
        t_end = t_start + duration
        if profile is None:
            while self.env.now < t_end:
                yield Timeout(rng.expovariate(rate))
                self.env.process(self.client_op(gid, wl.next_op()))
            return
        # piecewise-constant rate multipliers (scenario layer): each
        # segment restarts the exponential clock at its boundary — exact
        # under the memoryless property, and it keeps every segment's
        # draws a pure function of the seed and the segment list
        for s0, s1, factor in profile:
            seg_start, seg_end = t_start + s0, t_start + s1
            if self.env.now < seg_start:
                yield Timeout(seg_start - self.env.now)
            if factor <= 0.0:
                if self.env.now < seg_end:
                    yield Timeout(seg_end - self.env.now)
                continue
            while True:
                t_next = self.env.now + rng.expovariate(rate * factor)
                if t_next >= seg_end:
                    if self.env.now < seg_end:
                        yield Timeout(seg_end - self.env.now)
                    break
                yield Timeout(t_next - self.env.now)
                self.env.process(self.client_op(gid, wl.next_op()))

    # ------------------------------------------------------------- metrics
    def mean_latency(self, kind: Optional[str] = None,
                     dtype: Optional[str] = None) -> float:
        return self.records.mean_latency(kind, dtype)

    def tail_latency(self, q: float, kind: Optional[str] = None,
                     dtype: Optional[str] = None) -> float:
        """``q``-th percentile latency over the selected records (p95/p99
        at fig scale costs one ``np.percentile`` on the SoA buffer)."""
        return self.records.tail_latency(q, kind, dtype)

    def throughput(self) -> float:
        """Paper metric: average of per-client throughputs (§5.4.2).

        Uses the record buffer's cached single-pass per-group aggregates
        instead of rescanning all records once per group.
        """
        per_client = []
        for gid, (count, t_first, t_last) in self.records.group_stats().items():
            span = t_last - t_first
            if span > 0:
                per_client.append(count / span)
        return sum(per_client) / len(per_client) if per_client else 0.0

    def metrics(self) -> Dict[str, Any]:
        """Flat dotted-name metrics snapshot (the ``repro_torch.obs`` registry
        view of the ad-hoc counters: refusal accounting, lease outcomes,
        cache hit/miss, fault bookkeeping).  Built on demand from the
        live structures, so the simulation hot path pays nothing."""
        from repro_torch.obs import MetricsRegistry
        reg = MetricsRegistry()
        for k, v in self.refusals.items():
            reg.counter(f"sim.refusals.{k}").inc(v)
        for k, v in self.handoff_stats.items():
            reg.counter(f"sim.handoff.{k}").inc(v)
        reg.gauge("sim.handoff.pending").set(len(self.leases))
        for k, v in self.hot_stats.items():
            reg.counter(f"sim.hot.{k}").inc(v)
        reg.gauge("sim.hot.active").set(len(self.hot_keys))
        reg.counter("sim.lost_ops").inc(self.lost_ops)
        reg.counter("sim.churn.events").inc(len(self.churn_events))
        reg.gauge("sim.churn.epoch").set(self.churn_epoch)
        reg.gauge("sim.unavailable_keys").set(len(self.unavailable))
        if self.gw_cache:
            reg.counter("sim.cache.gateway.hits").inc(
                sum(c.hits for c in self.gw_cache.values()))
            reg.counter("sim.cache.gateway.misses").inc(
                sum(c.misses for c in self.gw_cache.values()))
        reg.counter("sim.cache.page.hits").inc(
            sum(g["page_cache"].hits for g in self.groups.values()))
        reg.counter("sim.cache.page.misses").inc(
            sum(g["page_cache"].misses for g in self.groups.values()))
        reg.counter("sim.records.count").inc(len(self.records))
        if len(self.records):
            reg.gauge("sim.latency.mean").set(self.mean_latency())
            reg.gauge("sim.latency.p95").set(self.tail_latency(95))
            reg.gauge("sim.latency.p99").set(self.tail_latency(99))
        return reg.snapshot()

    def trace_set(self, meta: Optional[dict] = None):
        """The run's spans as a :class:`repro_torch.obs.TraceSet` (requires
        ``trace=True``), with the metrics snapshot attached."""
        from repro_torch.obs import TraceSet
        return TraceSet.from_records(self.records, meta=meta,
                                     metrics=self.metrics())

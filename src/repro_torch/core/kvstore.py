"""EdgeKV storage module, edge groups, and the full cluster (EdgeKV §3.2).

Composition (paper Fig. 2):

* :class:`StorageModule` — per-node physical storage: **two separate
  key-value stores**, a local one for group-level data and a global one for
  system-level data (§3.2.5).
* :class:`EdgeGroup` — a replicated state machine over ``n`` edge nodes
  driven by :mod:`repro_torch.core.raft`; a write completes at a majority quorum,
  linearizable reads take a quorum round, serializable reads answer from
  any member (§5.4.1).
* :class:`EdgeKVCluster` — groups + gateway nodes + the Chord overlay
  (:mod:`repro_torch.core.hashring`) + the placement protocol and resource finder.

This synchronous implementation is the *functional* truth of the system
(used by unit/property tests and as the backing store of the framework
features). The latency behaviour of the very same protocol objects is
exercised by :mod:`repro_torch.sim`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

from .hashring import ChordRing
from .lease import LeaseTable, MigrationLease
from .raft import LocalCluster

LOCAL, GLOBAL = "local", "global"
_TOMBSTONE = object()


class StorageModule:
    """Physical storage on one edge node: separate local & global stores."""

    def __init__(self) -> None:
        self.stores: Dict[str, Dict[str, Any]] = {LOCAL: {}, GLOBAL: {}}

    def apply(self, cmd: Tuple[str, str, str, Any]) -> None:
        """State-machine apply for committed Raft entries."""
        op, dtype, key, value = cmd
        if op == "put":
            self.stores[dtype][key] = value
        elif op == "delete":
            self.stores[dtype].pop(key, None)
        else:  # pragma: no cover - guarded upstream
            raise ValueError(f"unknown op {op!r}")

    def get(self, dtype: str, key: str) -> Optional[Any]:
        return self.stores[dtype].get(key)


@dataclass
class OpResult:
    ok: bool
    value: Any = None
    # bookkeeping the simulator & tests use
    quorum_size: int = 0
    leader: Optional[str] = None


class EdgeGroup:
    """A Raft-replicated group of edge nodes (one RSM)."""

    def __init__(self, group_id: str, node_ids: List[str], *, seed: int = 0):
        self.id = group_id
        self.node_ids = list(node_ids)
        self.storage: Dict[str, StorageModule] = {
            nid: StorageModule() for nid in node_ids}
        # §7.3 mirrors of OTHER groups this group backs up, keyed by the
        # primary's id — kept apart from the authoritative `storage` so a
        # backup relationship can end (or rewire) without leaving replicated
        # residue behind.
        self.backup_storage: Dict[str, Dict[str, StorageModule]] = {}
        self._learner_groups: List["EdgeGroup"] = []
        self.learner_ids: List[str] = []
        self._seed = seed
        self.raft = LocalCluster(
            node_ids,
            apply_fns={nid: self.storage[nid].apply for nid in node_ids},
            seed=seed,
        )
        self.reachable = True  # network-partition flag (§7.3 failover)

    # ---------------------------------------------- network cut (split brain)
    def set_partition(self, sides: Dict[str, int]) -> None:
        """Cut this group's Raft links per the node -> side map (learner
        ids included); see :meth:`LocalCluster.set_partition`."""
        self.raft.set_partition(sides)

    def heal_partition(self) -> None:
        self.raft.heal_partition()

    def quorum_side(self) -> Optional[int]:
        return self.raft.quorum_side()

    def has_quorum(self) -> bool:
        """False while an active cut leaves no side with a voter majority
        (a straddled group): neither side may commit or serve linearizable
        reads, so writes refuse instead of acking stale."""
        return self.raft.quorum_side() is not None

    # -- §7.3: attach another group's nodes as non-voting learners.
    # May be called once per backup group: with ``backup_depth > 1`` a
    # primary attaches the nodes of several successor groups, each keeping
    # an independent mirror (crash tolerance beyond a single backup loss).
    def attach_learners(self, learner_group: "EdgeGroup") -> None:
        import random as _random
        from .raft import RaftNode, stable_seed
        # Mid-life attachment must NOT replay the full historical log: it
        # may contain migration tombstones (put k / delete k) for keys that
        # have since been handed to the learner's own group, and replaying
        # the delete would erase the live copy. InstallSnapshot semantics:
        # fast-forward the learner past the committed prefix and seed it
        # with the donor's *current* state instead.
        donor = max((self.raft.nodes[nid] for nid in self.node_ids),
                    key=lambda n: n.commit_index)
        snapshot = self.storage[donor.id].stores if donor.commit_index else {}
        # fresh per-primary mirror: any residue from an earlier backup
        # relationship (e.g. keys deleted while detached) is discarded, so
        # the put-only snapshot seed below fully defines the mirror state
        mirror = {nid: StorageModule() for nid in learner_group.node_ids}
        learner_group.backup_storage[self.id] = mirror
        self._learner_groups.append(learner_group)
        for nid in learner_group.node_ids:
            lid = f"{nid}@backup-of-{self.id}"
            node = RaftNode(
                lid, self.raft_ids() + [lid], voter=False,
                apply_fn=mirror[nid].apply,
                rng=_random.Random(self._seed * 31 + stable_seed(lid)),
            )
            node.voter_ids = set(self.node_ids)
            if donor.commit_index:
                node.log = list(donor.log)
                node.commit_index = donor.commit_index
                node.last_applied = donor.commit_index
                for dtype, kv in snapshot.items():
                    for k, v in kv.items():
                        node.apply_fn(("put", dtype, k, v))
            self.raft.nodes[lid] = node
            node.start(self.raft.now)
            self.learner_ids.append(lid)
        # existing nodes must know the new peer list to heartbeat learners
        for nid in self.node_ids:
            n = self.raft.nodes[nid]
            n.peers = [p for p in self.raft.nodes if p != nid]

    def detach_learners(self) -> None:
        """Drop all non-voting learners (elastic backup re-wiring), and the
        mirror they maintained — a no-longer-replicated copy must not
        survive to serve stale failover reads later."""
        for lid in self.learner_ids:
            self.raft.nodes.pop(lid, None)
        self.learner_ids.clear()
        for lg in self._learner_groups:
            lg.backup_storage.pop(self.id, None)
        self._learner_groups = []
        for nid in self.node_ids:
            n = self.raft.nodes[nid]
            n.peers = [p for p in self.raft.nodes if p != nid]
            n.next_index = {p: i for p, i in n.next_index.items()
                            if p in self.raft.nodes}
            n.match_index = {p: i for p, i in n.match_index.items()
                             if p in self.raft.nodes}

    def raft_ids(self) -> List[str]:
        return list(self.raft.nodes.keys())

    @property
    def n(self) -> int:
        return len(self.node_ids)

    def quorum(self) -> int:
        return self.n // 2 + 1

    # ------------------------------------------------------------ KV ops
    def put(self, dtype: str, key: str, value: Any) -> OpResult:
        if not self.has_quorum():
            return OpResult(False)  # cut splits the quorum: refuse, not ack
        lead = self.raft.run_until_leader()
        self.raft.propose(("put", dtype, key, value))
        return OpResult(True, quorum_size=self.quorum(), leader=lead.id)

    def delete(self, dtype: str, key: str) -> OpResult:
        if not self.has_quorum():
            return OpResult(False)
        lead = self.raft.run_until_leader()
        self.raft.propose(("delete", dtype, key, None))
        return OpResult(True, quorum_size=self.quorum(), leader=lead.id)

    def get(self, dtype: str, key: str, *, linearizable: bool = True) -> OpResult:
        if linearizable:
            if not self.has_quorum():
                return OpResult(False)  # ReadIndex needs a quorum round
            # etcd-style ReadIndex: the leader confirms leadership with a
            # heartbeat quorum round, then answers from its state machine.
            # LocalCluster.propose drives commits synchronously, so after the
            # heartbeat round the leader's storage is current by definition.
            lead = self.raft.run_until_leader()
            self.raft.step(0.0)  # heartbeat/ack round = the quorum check
            val = self.storage[lead.id].get(dtype, key)
            return OpResult(True, value=val, quorum_size=self.quorum(),
                            leader=lead.id)
        # serializable: any member may answer (possibly stale)
        member = self.node_ids[0]
        return OpResult(True, value=self.storage[member].get(dtype, key),
                        quorum_size=1, leader=None)

    def backup_get(self, primary_id: str, dtype: str, key: str) -> OpResult:
        """§7.3 failover read from the mirror this group keeps for
        ``primary_id`` — serializable (possibly stale), reads only."""
        mirror = self.backup_storage.get(primary_id)
        if mirror is None:
            return OpResult(False)
        member = self.node_ids[0]
        return OpResult(True, value=mirror[member].get(dtype, key),
                        quorum_size=1, leader=None)

    # -- fault injection used by tests and by EdgeKVCluster.crash_group
    def crash_all(self) -> List[str]:
        """Unplanned loss of every member (no drain, no goodbye). The
        group's Raft is dead; only learner mirrors on other groups'
        hosts survive."""
        for v in self.node_ids:
            self.raft.crash(v)
        self.reachable = False
        return list(self.node_ids)

    def crash_minority(self) -> List[str]:
        k = (self.n - 1) // 2
        victims = self.node_ids[-k:] if k else []
        for v in victims:
            self.raft.crash(v)
        return victims

    def crash_majority(self) -> List[str]:
        k = self.quorum()
        victims = self.node_ids[-k:]
        for v in victims:
            self.raft.crash(v)
        self.reachable = False
        return victims


class GatewayNode:
    """Gateway: DHT member + request router. Stores NO key-value data —
    only routing state (finger tables live in the shared ChordRing) and,
    optionally, a location cache (§7.2)."""

    def __init__(self, gw_id: str, group: EdgeGroup, ring: ChordRing,
                 cache_size: int = 0):
        from .cache import LRUCache
        self.id = gw_id
        self.group = group
        self.ring = ring
        self.location_cache = LRUCache(cache_size) if cache_size else None
        self.lookups = 0
        self.cache_hits = 0

    def locate(self, key: str) -> Tuple[str, List[str]]:
        """Find the gateway responsible for ``key``; returns (owner, path)."""
        if self.location_cache is not None:
            hit = self.location_cache.get(key)
            if hit is not None:
                self.cache_hits += 1
                return hit, [self.id, hit]
        self.lookups += 1
        path = self.ring.route(self.id, key)
        owner = path[-1]
        if self.location_cache is not None:
            self.location_cache.put(key, owner)
        return owner, path


class EdgeKVCluster:
    """The whole system: local layer (groups) + global layer (ring)."""

    def __init__(self, group_sizes: List[int], *, virtual_nodes: int = 1,
                 seed: int = 0, gateway_cache: int = 0,
                 backup_groups: bool = False, backup_depth: int = 1,
                 successors: int = 4):
        self.ring = ChordRing(virtual_nodes=virtual_nodes,
                              successors=successors)
        self.groups: Dict[str, EdgeGroup] = {}
        self.gateways: Dict[str, GatewayNode] = {}
        self.gateway_of_group: Dict[str, str] = {}
        self._seed = seed
        self._gateway_cache = gateway_cache
        self._backup_groups = backup_groups
        self._backup_depth = max(1, int(backup_depth))
        self._next_gi = 0
        self.migrations: List[Tuple[str, str, int]] = []  # (event, gid, keys)
        # crashed groups pending recovery: gid -> (dead EdgeGroup, its
        # backup chain at crash time) — the chain names where the mirrors
        # live, so recovery must remember it even though the live maps
        # drop the dead group immediately.
        self.dead_groups: Dict[str, Tuple[EdgeGroup, List[str]]] = {}
        # dead gid -> live gid now serving its promoted local data
        self.promoted_local: Dict[str, str] = {}
        # ------- async handoff state (per-key migration leases) -------
        self.leases = LeaseTable()
        # key -> set of dead gids whose pending mirror promotion must NOT
        # resurrect it: the key was deleted at its (new) owner during the
        # unavailability / migration window, and the delete wins
        self.tombstones: Dict[str, Set[str]] = {}
        # ------- hot-key read replicas (§7.3 mirror machinery) -------
        # key -> {"owner": gid at install, "value": ..., "hits": int}; a
        # bounded set of extra read replicas for skew-detected hot keys.
        # Writes still linearize through the owner; the entry is revoked
        # on every put/delete/lease-acquire (same discipline as the
        # tombstone revoke-on-put above), so a mirror read can never
        # resurrect a deleted key or serve a superseded value.
        self.hot_mirrors: Dict[str, dict] = {}
        self.hot_mirror_limit = 16
        self.hot_stats: Dict[str, int] = dict(
            installed=0, dropped=0, invalidated=0, mirror_reads=0)
        # async handoff jobs: job id -> bookkeeping; a job finalizes (e.g.
        # actually dropping a drained group) once its last lease resolves
        self.handoff_jobs: Dict[int, dict] = {}
        self._next_job = 0
        self.draining: Set[str] = set()     # gids mid-async-drain
        self._drain_via: Dict[str, str] = {}  # draining gw -> substitute gw
        # ------- network partition state (scenario engine) -------
        # gid -> side (0/1) while a cut is active; None = no cut. A cut
        # gates *availability*, never ownership: the ring and the lease
        # table are untouched, so healing can never double-own a key.
        self.partition_of: Optional[Dict[str, int]] = None
        self.partition_straddle: Dict[str, int] = {}  # gid -> members on side 1
        self.partition_minority = 1
        # gid -> side that still holds the group's quorum (None when the
        # cut splits it); precomputed at cut time for the refusal checks
        self._quorum_side_of: Dict[str, Optional[int]] = {}
        self._partitioned_rafts: List[str] = []
        self.partition_log: List[Tuple[str, Any]] = []
        # client-visible unavailability accounting: refused ops never
        # mutate state, they are *counted* instead of acked stale
        self.refusals: Dict[str, int] = dict(
            put=0, get=0, delete=0, cross_cut=0, no_quorum=0,
            minority_side=0, majority_side=0)
        # crashed-out identities that may re-join under their old gateway
        # id: gid -> (gw_id, node_ids, group seed)
        self.former_groups: Dict[str, Tuple[str, List[str], int]] = {}
        for size in group_sizes:
            self._spawn_group(size, weight=1.0)
        self.backup_of: Dict[str, str] = {}        # gid -> first backup
        self.backup_chain: Dict[str, List[str]] = {}  # gid -> full chain
        if backup_groups and len(group_sizes) >= 2:
            from .backup import assign_backup_groups
            assign_backup_groups(self)

    def _spawn_group(self, size: int, *, weight: float) -> Tuple[str, str]:
        gi = self._next_gi
        self._next_gi += 1
        gid, gw_id = f"g{gi}", f"gw{gi}"
        nodes = [f"{gid}-st{j}" for j in range(size)]
        self.groups[gid] = EdgeGroup(gid, nodes, seed=self._seed + gi)
        self.ring.add_node(gw_id, weight=weight)
        self.gateways[gw_id] = GatewayNode(
            gw_id, self.groups[gid], self.ring,
            cache_size=self._gateway_cache)
        self.gateway_of_group[gid] = gw_id
        return gid, gw_id

    # -------------------------------------------------- elastic membership
    def _invalidate_location_caches(self) -> None:
        """Ring membership changed: every §7.2 location cache may now point
        at the wrong owner — clear them (K/m keys re-learn on next lookup)."""
        for gw in self.gateways.values():
            if gw.location_cache is not None:
                gw.location_cache.invalidate()

    # ------------------------------------------- network partitions (cuts)
    def _require_whole_view(self, what: str) -> None:
        if self.partition_of is not None:
            raise RuntimeError(
                f"cluster is partitioned: {what} needs a global view — "
                "heal the cut first")

    def partition(self, side: "List[str]", *,
                  straddle: Optional[Dict[str, int]] = None) -> None:
        """Install a network cut: groups listed in ``side`` land on side 1,
        every other group on side 0. ``straddle`` maps group ids to the
        number of their *members* stranded on side 1 (the last ``k`` node
        ids), modeling a Raft group whose quorum spans the cut.

        Semantics (split-brain prevention by refusal, not failover):

        * each group's Raft links are cut per-node (learner mirrors hosted
          across the cut stop receiving entries — realistic divergence);
        * a straddled group with no majority side refuses writes and
          linearizable reads entirely;
        * cross-cut client ops refuse at the gateway (counted in
          :attr:`refusals`) instead of acking stale;
        * ownership never moves: the ring, promotion pointers, and lease
          table are untouched, so :meth:`heal_partition` cannot create a
          double owner or resurrect a deleted key.
        """
        if self.partition_of is not None:
            raise RuntimeError("a partition is already active")
        cut = set(side)
        unknown = cut - set(self.groups)
        if unknown:
            raise KeyError(
                f"unknown group(s) in partition side: {sorted(unknown)}")
        straddle = dict(straddle or {})
        for gid, k in straddle.items():
            grp = self.groups[gid]
            if not 0 < k < grp.n:
                raise ValueError(
                    f"straddle {gid!r}: need 0 < side-1 members < {grp.n}")
            if gid in cut:
                raise ValueError(
                    f"straddling group {gid!r} spans the cut; do not also "
                    "list it in `side`")
        self.partition_of = {gid: (1 if gid in cut else 0)
                             for gid in self.groups}
        self.partition_straddle = straddle
        n1 = sum(self.partition_of.values())
        self.partition_minority = 1 if n1 * 2 <= len(self.partition_of) else 0
        self._partitioned_rafts = []
        self._quorum_side_of = {}
        for gid, group in self.groups.items():
            own = self.partition_of[gid]
            k = straddle.get(gid, 0)
            assign: Dict[str, int] = {}
            for j, nid in enumerate(group.node_ids):
                assign[nid] = 1 if (k and j >= group.n - k) else own
            # learner mirrors live on their host group's side of the cut
            for lg in group._learner_groups:
                lside = self.partition_of[lg.id]
                for nid in lg.node_ids:
                    assign[f"{nid}@backup-of-{gid}"] = lside
            if len(set(assign.values())) > 1:
                group.set_partition(assign)
                self._partitioned_rafts.append(gid)
            self._quorum_side_of[gid] = group.quorum_side() \
                if gid in self._partitioned_rafts else own
        self.partition_log.append(
            ("cut", dict(side=sorted(cut), straddle=dict(straddle))))

    def heal_partition(self) -> int:
        """Remove the cut and reconcile the divergent views.

        Ownership never moved, so the merge is replay, not arbitration:
        each cut Raft re-converges (one disruptive re-election at most)
        and its cross-cut learner mirrors catch up to the leader's
        committed log — so a crash right after the heal cannot lose
        acknowledged writes to a stale mirror. The Chord stabilization
        pass is a no-op replay asserting the overlay stayed converged.
        Deferred cross-cut leases resume with their dirty/tombstone flags
        carried over. Returns the number of groups whose Raft was cut.
        """
        if self.partition_of is None:
            raise RuntimeError("no active partition")
        partitioned = self._partitioned_rafts
        self.partition_of = None
        self.partition_straddle = {}
        self._quorum_side_of = {}
        self._partitioned_rafts = []
        for gid in partitioned:
            group = self.groups[gid]
            group.heal_partition()
            self._replay_backlog(group)
        while not self.ring.stabilized:  # pragma: no cover - cuts never
            self.ring.stabilize()        # mutate the ring, so this is the
            self.ring.fix_fingers()      # promised (no-op) replay pass
        self.partition_log.append(("heal", dict(self.refusals)))
        return len(partitioned)

    def _replay_backlog(self, group: EdgeGroup) -> None:
        """Post-heal stabilization replay: drive ``group``'s Raft until
        every live learner mirror has applied the leader's committed
        prefix (the entries that crossed the cut only now)."""
        raft = group.raft
        lead = raft.run_until_leader()
        for _ in range(200):
            learners = [raft.nodes[lid] for lid in group.learner_ids
                        if lid in raft.nodes and lid not in raft.down]
            if all(n.last_applied >= lead.commit_index for n in learners):
                return
            raft.step()
            lead = raft.run_until_leader()
        raise RuntimeError(  # pragma: no cover - bounded replay failed
            f"learner mirrors of {group.id!r} did not catch up after heal")

    def _count_refusal(self, op: str, client_side: Optional[int],
                       why: str) -> None:
        self.refusals[op] += 1
        self.refusals[why] += 1
        if client_side is not None:
            self.refusals["minority_side"
                          if client_side == self.partition_minority
                          else "majority_side"] += 1

    def _partition_check(self, op: str, client_gid: str,
                         owner_gid: str) -> Optional[OpResult]:
        """Split-brain guard for one op: a counted, non-mutating refusal
        when the op's authority is unreachable from the client's side of
        the cut (or has no quorum side at all); ``None`` = allowed."""
        if self.partition_of is None:
            return None
        cs = self._quorum_side_of.get(client_gid)
        qs = self._quorum_side_of.get(owner_gid)
        if cs is None or qs is None:
            self._count_refusal(op, cs, "no_quorum")
            return OpResult(False)
        if cs != qs:
            self._count_refusal(op, cs, "cross_cut")
            return OpResult(False)
        return None

    def _lease_deferred(self, lease: MigrationLease) -> bool:
        """True when an active cut blocks resolving ``lease``: background
        migration needs the destination's quorum and (unless staged) the
        source on the same side — a deferred lease simply waits for the
        heal, its dirty/tombstone flags intact."""
        if self.partition_of is None:
            return False
        dside = self._quorum_side_of.get(lease.dst)
        if dside is None:
            return True
        if lease.src is not None and not lease.staged:
            sside = self._quorum_side_of.get(lease.src)
            if sside is None or sside != dside:
                return True
        return False

    def add_group(self, size: int, *, weight: float = 1.0,
                  async_handoff: bool = False) -> str:
        """Join a new edge group + gateway at runtime (elastic scale-out).

        The gateway enters the Chord overlay (incremental finger update),
        then the global keys whose successor changed are handed off: each is
        read from its old owner with a linearizable barrier, committed into
        the new group's Raft log, verified readable at the new owner, and
        only then deleted at the source — so no key is ever lost, and a key
        is double-owned only while the ring already routes to the new owner.

        With ``async_handoff=True`` the moving keys are *leased* to the new
        group instead of migrated in place: the ring routes to the new
        owner immediately, client ops keep flowing (writes commit at the
        destination and supersede the source copy, reads pull their key on
        demand), and the bulk of the migration is driven incrementally by
        :meth:`step_handoff`. Planned membership changes serialize behind
        an in-flight handoff (only a crash interrupts one), so at most one
        handoff job is ever active.
        """
        self._require_whole_view("membership change (add_group)")
        self.drain_handoff()
        # Snapshot ownership BEFORE the ring changes. Leader stores hold
        # only keys their group authoritatively owns (§7.3 mirrors live in
        # backup_storage, never here); the locate() filter is defensive —
        # it keeps the handoff correct even if that invariant ever drifts.
        owned_before: List[Tuple[str, EdgeGroup]] = []
        for other_gw, gw in self.gateways.items():
            if other_gw not in self.ring.nodes:
                continue  # draining gateway: already off the ring
            src = gw.group
            lead = src.raft.run_until_leader()
            src.raft.step(0.0)  # read barrier: leader state is current
            owned_before.extend(
                (k, src) for k in list(src.storage[lead.id].stores[GLOBAL])
                if self.ring.locate(k) == other_gw)
        gid, gw_id = self._spawn_group(size, weight=weight)
        self._invalidate_location_caches()
        if async_handoff:
            job = self._start_job("add", gid)
            for key, src in owned_before:
                if self.ring.locate(key) == gw_id and key not in self.leases:
                    self._acquire_lease(key, src.id, gid, job)
            self._rewire_backups()
            self.migrations.append(("add-async", gid,
                                    self.handoff_jobs[job]["leased"]))
            self._maybe_finalize(job)
            return gid
        moved = 0
        dest = self.groups[gid]
        for key, src in owned_before:
            if self.ring.locate(key) == gw_id:
                moved += self._migrate_key(src, dest, key)
        self._rewire_backups()
        self.migrations.append(("add", gid, moved))
        return gid

    def remove_group(self, gid: str, *, async_handoff: bool = False) -> int:
        """Drain a group and leave the ring (elastic scale-in).

        Global keys the group owned are re-homed to their new successor
        groups through those groups' Raft logs *after* the gateway has left
        the overlay, so lookups during the (synchronous) drain already route
        to the surviving owners. Local data is group-scoped by definition
        (§3.2.5) and leaves with the group. Returns the number of keys
        migrated.

        With ``async_handoff=True`` the drain is incremental: the gateway
        leaves the overlay immediately and every owned global key is leased
        to its new ring owner; the group object stays alive (serving lease
        pulls and its clients' local data) until the last lease resolves,
        at which point the group is finalized out of the cluster. Returns
        the number of keys leased. Planned membership changes serialize
        behind an in-flight handoff (see :meth:`add_group`).
        """
        self._require_whole_view("membership change (remove_group)")
        if gid not in self.groups:
            raise KeyError(gid)
        if gid in self.draining:
            raise RuntimeError(f"{gid!r} is already draining")
        if len(self.groups) - len(self.draining) < 2:
            raise RuntimeError("cannot remove the last group")
        self.drain_handoff()
        # abrupt-loss edge case: a draining group may hold the only
        # surviving mirror of a crashed group awaiting recovery — letting
        # it leave would destroy the last copy of acknowledged writes
        for dead_gid, (_, dead_chain) in self.dead_groups.items():
            if not any(b in self.groups and b != gid
                       and b not in self.draining for b in dead_chain):
                raise RuntimeError(
                    f"cannot remove {gid!r}: it holds the last surviving "
                    f"mirror of crashed group {dead_gid!r} — recover it "
                    "first")
        gw_id = self.gateway_of_group[gid]
        src = self.groups[gid]
        # Adopted local data of crashed groups this group promoted must
        # move out before the drain destroys the store (the drain below
        # only re-homes GLOBAL keys) — it re-homes to the drained group's
        # ring successor, and the promotion pointers follow. The async
        # drain leases this namespace instead (below), keeping the drain
        # zero-downtime end to end.
        if not async_handoff:
            self._migrate_adopted_local(gid, gw_id)
        # End the draining group's backup relationship BEFORE the handoff:
        # the group is leaving, so its mirror must not outlive it, and the
        # handoff's src.delete traffic has no business replicating to a
        # backup that will be rewired by _rewire_backups below anyway.
        src.detach_learners()
        self.backup_of.pop(gid, None)
        self.backup_chain.pop(gid, None)
        lead = src.raft.run_until_leader()
        src.raft.step(0.0)  # read barrier before snapshotting ownership
        # defensive ownership filter (see add_group): the leader store holds
        # only keys this gateway owns; mirrors live in backup_storage
        owned = [k for k in src.storage[lead.id].stores[GLOBAL]
                 if self.ring.locate(k) == gw_id]
        substitute = (self.ring.successor_group(gw_id)
                      if len(self.ring) >= 2 else None)
        self.ring.remove_node(gw_id)
        self._invalidate_location_caches()
        if async_handoff:
            # incremental drain: lease every owned key to its new ring
            # owner; the group object outlives the membership change and
            # is finalized once the last lease resolves
            self.draining.add(gid)
            if substitute is not None:
                self._drain_via[gw_id] = substitute
            job = self._start_job("remove", gid)
            for key in owned:
                if key not in self.leases:
                    dest_gid = self.gateways[self.ring.locate(key)].group.id
                    self._acquire_lease(key, gid, dest_gid, job)
            # adopted-local namespace: lease the promoted "<dead>::" keys
            # to the drained group's ring successor instead of moving them
            # synchronously; the promotion pointer flips at acquisition
            # (the lease arbitrates authority meanwhile, same as global).
            # Caveat: the lease table is keyed by key alone, so a global
            # key spelled exactly like a namespaced local one would
            # collide — repo keyspaces never use the "<gid>::" shape.
            adopted = sorted(dead for dead, host
                             in self.promoted_local.items() if host == gid)
            if adopted and substitute is not None:
                from .backup import PROMOTED_SEP
                new_host_gid = self.gateways[substitute].group.id
                lead = src.raft.run_until_leader()
                src.raft.step(0.0)  # read barrier before snapshotting
                prefixes = tuple(f"{d}{PROMOTED_SEP}" for d in adopted)
                for key in [k for k in src.storage[lead.id].stores[LOCAL]
                            if k.startswith(prefixes)]:
                    if key not in self.leases:
                        self._acquire_lease(key, gid, new_host_gid, job,
                                            tier=LOCAL)
                for dead in adopted:
                    self.promoted_local[dead] = new_host_gid
            self._rewire_backups()
            leased = self.handoff_jobs[job]["leased"]
            self.migrations.append(("remove-async", gid, leased))
            self._maybe_finalize(job)
            return leased
        moved = 0
        for key in owned:
            dest = self.gateways[self.ring.locate(key)].group
            moved += self._migrate_key(src, dest, key)
        del self.groups[gid]
        del self.gateways[gw_id]
        del self.gateway_of_group[gid]
        self.backup_of = {g: b for g, b in self.backup_of.items()
                          if g != gid and b != gid}
        self.backup_chain = {g: c for g, c in self.backup_chain.items()
                             if g != gid}
        self._rewire_backups()
        self.migrations.append(("remove", gid, moved))
        return moved

    def reweight_group(self, gid: str, weight: float, *,
                       async_handoff: bool = False) -> int:
        """Change a live group's §7.1 ring weight in place (the feedback
        half of the rebalance loop).

        The vnode delta is incremental — :meth:`ChordRing.reweight_node`
        adds or removes only the suffix of the group's vnode sequence that
        the new weight implies, leaving every other arc untouched — and the
        keys whose successor changed (in *either* direction: arcs shed by a
        shrinking group, arcs captured by a growing one) are re-homed with
        the same write -> read-barrier -> delete migration as
        :meth:`add_group`. With ``async_handoff=True`` the moved keys are
        leased instead, so client writes never stall behind the rebalance.
        Returns the number of keys migrated (or leased).
        """
        self._require_whole_view("membership change (reweight_group)")
        if gid not in self.groups:
            raise KeyError(gid)
        if gid in self.draining:
            raise RuntimeError(f"cannot reweight {gid!r}: it is mid-drain")
        gw_id = self.gateway_of_group[gid]
        self.drain_handoff()
        # snapshot ownership BEFORE the ring changes (see add_group): the
        # delta may move arcs toward OR away from gid, so every live
        # gateway is a potential source
        owned_before: List[Tuple[str, EdgeGroup]] = []
        for other_gw, gw in self.gateways.items():
            if other_gw not in self.ring.nodes:
                continue  # draining gateway: already off the ring
            src = gw.group
            lead = src.raft.run_until_leader()
            src.raft.step(0.0)  # read barrier: leader state is current
            owned_before.extend(
                (k, src) for k in list(src.storage[lead.id].stores[GLOBAL])
                if self.ring.locate(k) == other_gw)
        added, removed = self.ring.reweight_node(gw_id, weight)
        if not added and not removed:
            # same vnode count: nothing can have moved — skip the cache
            # flush and the (empty) handoff entirely
            self.migrations.append(("reweight", gid, 0))
            return 0
        self._invalidate_location_caches()
        moving = [(key, src) for key, src in owned_before
                  if self.ring.locate(key)
                  != self.gateway_of_group[src.id]]
        if async_handoff:
            job = self._start_job("reweight", gid)
            for key, src in moving:
                if key not in self.leases:
                    dest_gid = self.gateways[self.ring.locate(key)].group.id
                    self._acquire_lease(key, src.id, dest_gid, job)
            self._rewire_backups()
            leased = self.handoff_jobs[job]["leased"]
            self.migrations.append(("reweight-async", gid, leased))
            self._maybe_finalize(job)
            return leased
        moved = 0
        for key, src in moving:
            dest = self.gateways[self.ring.locate(key)].group
            moved += self._migrate_key(src, dest, key)
        self._rewire_backups()
        self.migrations.append(("reweight", gid, moved))
        return moved

    # ------------------------------------------- hot-key read replicas
    def replicate_hot_key(self, key: str) -> bool:
        """Install a bounded extra read replica for a skew-detected hot
        key, seeded with a linearizable read at the owner (§7.3 mirror
        machinery; writes still linearize through the owner and revoke the
        replica, see :func:`repro_torch.core.resource_finder.resource_put`).
        Refusals — active cut, leased key, replica budget exhausted,
        unreachable owner — are non-mutating and return ``False``."""
        if key in self.hot_mirrors:
            return True
        if self.partition_of is not None:
            return False  # no global view: the seed read may be stale
        if self.dead_groups:
            # unavailability window: the key's value may survive only in
            # a §7.3 backup mirror awaiting promotion — a linearizable
            # read at the (new) ring owner would seed the replica with a
            # miss and serve it even after recovery
            return False
        if key in self.leases:
            return False  # authority is mid-flight
        if len(self.hot_mirrors) >= self.hot_mirror_limit:
            return False
        group = self.gateways[self.ring.locate(key)].group
        if not group.reachable:
            return False
        res = group.get(GLOBAL, key, linearizable=True)
        if not res.ok:
            return False
        self.hot_mirrors[key] = dict(owner=group.id, value=res.value,
                                     hits=0)
        self.hot_stats["installed"] += 1
        return True

    def unreplicate_hot_key(self, key: str) -> bool:
        """Drop a hot-key replica (the key cooled off). Idempotent."""
        if self.hot_mirrors.pop(key, None) is None:
            return False
        self.hot_stats["dropped"] += 1
        return True

    def _migrate_adopted_local(self, gid: str, gw_id: str) -> None:
        """Move the namespaced local data ``gid`` adopted from crashed
        groups (see :func:`repro_torch.core.backup.promote_backup`) to the
        drained group's ring successor, with the same write -> read
        barrier -> delete handoff as global keys, and re-point the
        promotion chain."""
        adopted = [dead for dead, host in self.promoted_local.items()
                   if host == gid]
        if not adopted:
            return
        from .backup import PROMOTED_SEP
        src = self.groups[gid]
        new_host_gw = self.ring.successor_group(gw_id)
        new_host = self.gateways[new_host_gw].group
        lead = src.raft.run_until_leader()
        src.raft.step(0.0)  # read barrier before snapshotting
        prefixes = tuple(f"{dead}{PROMOTED_SEP}" for dead in adopted)
        for key in [k for k in src.storage[lead.id].stores[LOCAL]
                    if k.startswith(prefixes)]:
            val = src.get(LOCAL, key, linearizable=True).value
            new_host.put(LOCAL, key, val)
            check = new_host.get(LOCAL, key, linearizable=True)
            if not check.ok or check.value != val:  # pragma: no cover
                raise RuntimeError(
                    f"adopted-local handoff verification failed for {key!r}")
            src.delete(LOCAL, key)
        for dead in adopted:
            self.promoted_local[dead] = new_host.id

    # --------------------------------------------------- crash + recovery
    def crash_group(self, gid: str) -> str:
        """Unplanned loss of a whole group and its gateway — no drain, no
        goodbye (contrast :meth:`remove_group`).

        The gateway leaves the Chord ownership arrays abruptly
        (:meth:`ChordRing.crash_node`): key ranges transfer to the
        successors immediately, but finger tables and successor lists
        keep dangling references until ``stabilize()``/``fix_fingers()``
        repair them (routing skips dead fingers meanwhile). The group's
        data survives only in the §7.3 mirrors its backup chain holds;
        :meth:`recover_group` promotes them. Raises instead of mutating
        anything when the crash exceeds the fault tolerance (last group,
        a dead successor chain, or no surviving backup for some dead
        group's mirrors).
        """
        self._require_whole_view("membership change (crash_group)")
        if gid not in self.groups:
            raise KeyError(gid)
        if gid in self.draining:
            raise RuntimeError(
                f"cannot crash {gid!r}: it is mid-drain (its gateway "
                "already left the overlay; let the drain finish)")
        if len(self.groups) - len(self.draining) < 2:
            raise RuntimeError(
                f"cannot crash {gid!r}: it is the last live group")
        group = self.groups[gid]
        chain = list(self.backup_chain.get(gid, []))
        if self._backup_groups:
            # storage-level survivability: every dead group (including
            # this victim) must keep >= 1 live backup holding its mirror.
            # A draining group doesn't count — it is leaving and its
            # stores (mirrors included) die at finalize.
            for dead_gid, (_, dead_chain) in list(self.dead_groups.items()) \
                    + [(gid, (group, chain))]:
                if not any(b in self.groups and b != gid
                           and b not in self.draining
                           for b in dead_chain):
                    raise RuntimeError(
                        f"cannot crash {gid!r}: no surviving backup would "
                        f"hold {dead_gid!r}'s mirror (backup_depth="
                        f"{self._backup_depth} tolerates at most "
                        f"{self._backup_depth} overlapping crashes)")
        # adopted-local migration leases are not crash-recoverable (the
        # namespaced keys are not ring-addressed, so no retarget rule
        # exists for them) — refuse the crash instead of corrupting the
        # promotion chain, like the other exceeded-fault-tolerance cases
        for lease in self.leases.active():
            if lease.tier == LOCAL and gid in (lease.src, lease.dst):
                raise RuntimeError(
                    f"cannot crash {gid!r}: adopted-local handoff in "
                    "flight (drain it first)")
        gw_id = self.gateway_of_group[gid]
        # the ring guard raises before any mutation (last node / dead
        # successor chain), so a refused crash leaves the cluster intact
        self.ring.crash_node(gw_id)
        group.crash_all()
        self.dead_groups[gid] = (group, chain)
        self.former_groups[gid] = (gw_id, list(group.node_ids), group._seed)
        del self.groups[gid]
        del self.gateways[gw_id]
        del self.gateway_of_group[gid]
        self.backup_of.pop(gid, None)
        self.backup_chain.pop(gid, None)
        self.backup_of = {g: b for g, b in self.backup_of.items()
                          if b != gid}
        self._crash_lease_fixups(gid)
        self._invalidate_location_caches()
        # live groups that used the dead group as a backup re-wire to the
        # ring's new successor rule right away (the dead group's own
        # mirrors are untouched: they live on its backups' hosts)
        self._rewire_backups()
        self.migrations.append(("crash", gid, 0))
        return gid

    def recover_group(self, gid: str, *, stabilize: bool = True,
                      async_handoff: bool = False) -> int:
        """§7.3 backup promotion for a crashed group; returns the number
        of re-homed global keys.

        The first surviving backup in the dead group's chain donates its
        mirror (applied learner state plus the unapplied tail of the
        learner's log — nothing acknowledged is lost, nothing from before
        the snapshot seed is replayed). Global keys re-home to their
        current ring owners through those owners' Raft logs with the
        linearizable read barrier; a key the new owner already committed
        *after* the crash wins over the mirror copy (last-write-wins, no
        rollback); a key *deleted* at its new owner during the
        unavailability window carries a tombstone that wins over the
        mirror copy too. Local data is promoted into the backup group
        under a namespaced key range and stays addressable via the dead
        group id.

        With ``async_handoff=True`` the re-homing half is leased instead
        of pushed: each promoted value is frozen onto a *staged* lease to
        its ring owner, reads pull their key on demand (shrinking the
        per-key unavailability window), writes at the owner supersede the
        stale mirror copy, and :meth:`step_handoff` drains the rest in
        the background.
        """
        from .backup import promote_backup
        self._require_whole_view("membership change (recover_group)")
        if gid not in self.dead_groups:
            raise KeyError(f"{gid!r} is not a crashed group pending "
                           "recovery")
        self.drain_handoff()  # membership changes serialize behind handoffs
        moved = promote_backup(self, gid, async_handoff=async_handoff)
        if stabilize:
            while not self.ring.stabilized:
                self.ring.stabilize()
                self.ring.fix_fingers()
        self.migrations.append(
            ("recover-async" if async_handoff else "recover", gid, moved))
        return moved

    def rejoin_group(self, gid: str) -> int:
        """Re-join a crashed-and-recovered group under its OLD identity.

        The returning gateway re-enters the overlay with the same id, and
        vnode positions are a pure hash of that id — so it reclaims
        exactly the key ranges it owned before the crash. Only those keys
        move back (plus the adopted local data promoted at recovery,
        which returns home and drops its promotion pointer), instead of
        the second full reshuffle a fresh ``add_group`` identity would
        pay on top of the one the crash already caused. The group's
        stores start empty (fresh hosts, same names): state returns via
        the handoff, never from the dead Raft logs. Returns the number of
        keys moved back.
        """
        self._require_whole_view("membership change (rejoin_group)")
        if gid in self.groups:
            raise RuntimeError(f"{gid!r} is already a live group")
        if gid in self.dead_groups:
            raise RuntimeError(
                f"{gid!r} is still crashed: recover it first (re-join "
                "needs its mirrors promoted and the ring stabilized)")
        former = self.former_groups.get(gid)
        if former is None:
            raise KeyError(f"{gid!r} never crashed out of this cluster")
        gw_id, node_ids, seed = former
        self.drain_handoff()  # membership serializes behind handoffs
        # ownership snapshot BEFORE the ring changes (same rule as
        # add_group: leader stores hold only authoritatively owned keys)
        owned_before: List[Tuple[str, EdgeGroup]] = []
        for other_gw, gw in self.gateways.items():
            if other_gw not in self.ring.nodes:
                continue  # draining gateway: already off the ring
            src = gw.group
            lead = src.raft.run_until_leader()
            src.raft.step(0.0)  # read barrier: leader state is current
            owned_before.extend(
                (k, src) for k in list(src.storage[lead.id].stores[GLOBAL])
                if self.ring.locate(k) == other_gw)
        group = EdgeGroup(gid, node_ids, seed=seed)
        self.ring.add_node(gw_id)  # same id -> same vnode positions
        self._invalidate_location_caches()
        self.groups[gid] = group
        self.gateways[gw_id] = GatewayNode(
            gw_id, group, self.ring, cache_size=self._gateway_cache)
        self.gateway_of_group[gid] = gw_id
        moved = 0
        for key, src in owned_before:
            if self.ring.locate(key) == gw_id:
                moved += self._migrate_key(src, group, key)
        # adopted local data promoted at recovery returns home: walk the
        # promotion chain to its current live host, strip the namespace
        if gid in self.promoted_local:
            from .backup import PROMOTED_SEP
            prefix = f"{gid}{PROMOTED_SEP}"
            host_gid = self.promoted_local[gid]
            while host_gid not in self.groups:
                prefix = f"{host_gid}{PROMOTED_SEP}{prefix}"
                host_gid = self.promoted_local[host_gid]
            host = self.groups[host_gid]
            lead = host.raft.run_until_leader()
            host.raft.step(0.0)  # read barrier before snapshotting
            for key in [k for k in host.storage[lead.id].stores[LOCAL]
                        if k.startswith(prefix)]:
                val = host.get(LOCAL, key, linearizable=True).value
                group.put(LOCAL, key[len(prefix):], val)
                host.delete(LOCAL, key)
                moved += 1
            del self.promoted_local[gid]
        self._rewire_backups()
        del self.former_groups[gid]
        self.migrations.append(("rejoin", gid, moved))
        return moved

    # ------------------------------------------------ async handoff driver
    def _start_job(self, kind: str, gid: str) -> int:
        job = self._next_job
        self._next_job += 1
        self.handoff_jobs[job] = dict(kind=kind, gid=gid, leased=0,
                                      pending=0, resolved=0, done=False)
        return job

    def _acquire_lease(self, key: str, src: Optional[str], dst: str,
                       job: Optional[int], *, value: Any = None,
                       staged: bool = False,
                       tier: str = GLOBAL) -> MigrationLease:
        lease = self.leases.acquire(key, src, dst, job=job, value=value,
                                    staged=staged, tier=tier)
        # a key entering migration loses its hot mirror: authority is in
        # flight, so the bounded replica may no longer track the owner
        if self.hot_mirrors.pop(key, None) is not None:
            self.hot_stats["invalidated"] += 1
        if job is not None:
            self.handoff_jobs[job]["leased"] += 1
            self.handoff_jobs[job]["pending"] += 1
        return lease

    def _release_lease(self, lease: MigrationLease, outcome: str) -> None:
        self.leases.release(lease.key, outcome)
        job = lease.job
        if job is None:
            return
        j = self.handoff_jobs[job]
        j["pending"] -= 1
        j["resolved"] += 1
        self._maybe_finalize(job)

    def _maybe_finalize(self, job: int) -> None:
        j = self.handoff_jobs[job]
        if j["pending"] or j["done"]:
            return
        j["done"] = True
        if j["kind"] == "remove" and j["gid"] in self.groups:
            self._finalize_remove(j["gid"])
        self.migrations.append(("handoff", j["gid"], j["resolved"]))

    def _finalize_remove(self, gid: str) -> None:
        """Last lease of an async drain resolved: the group actually
        leaves the cluster (its Raft stores now hold no global keys it
        owned; local data left with it, §3.2.5)."""
        gw_id = self.gateway_of_group[gid]
        self.groups[gid].detach_learners()
        del self.groups[gid]
        del self.gateways[gw_id]
        del self.gateway_of_group[gid]
        self.draining.discard(gid)
        self._drain_via.pop(gw_id, None)
        self.backup_of = {g: b for g, b in self.backup_of.items()
                          if g != gid and b != gid}
        self.backup_chain = {g: c for g, c in self.backup_chain.items()
                             if g != gid}
        self._rewire_backups()

    def step_handoff(self, max_keys: Optional[int] = None) -> int:
        """Resolve up to ``max_keys`` pending leases (all by default) in
        acquisition order — the incremental background half of the async
        handoff. Returns the number of leases resolved. Safe to call at
        any time; client ops may race it (a read may have pulled a lease
        before this step reaches it)."""
        resolved = 0
        for lease in list(self.leases.active()):
            if max_keys is not None and resolved >= max_keys:
                break
            if self.leases.get(lease.key) is not lease:
                continue  # pulled by a concurrent read
            if self._lease_deferred(lease):
                continue  # blocked behind an active cut; resumes at heal
            self._resolve_lease(lease)
            resolved += 1
        return resolved

    def drain_handoff(self) -> int:
        """Resolve every pending lease (the atomic-membership entry points
        call this first, so overlapping membership operations serialize
        behind the in-flight handoff). Under an active cut, leases whose
        endpoints straddle it stay deferred — the drain stops instead of
        spinning on them."""
        total = 0
        while self.leases:
            n = self.step_handoff()
            total += n
            if n == 0:
                break  # every remaining lease is deferred across a cut
        return total

    @property
    def pending_handoff(self) -> int:
        return len(self.leases)

    def _resolve_lease(self, lease: MigrationLease) -> None:
        """Complete or discard one lease from current state:

        * tombstone — the delete at the destination won; drop the stale
          source copy, never copy anything;
        * dirty — a write at the destination superseded the source copy;
          drop it;
        * pending — migrate the value (linearizable read at the source —
          or the staged mirror value — commit at the destination, verify
          at a quorum, delete at the source).
        """
        tier = lease.tier
        src = self.groups.get(lease.src) if lease.src is not None else None
        if lease.tombstone or lease.dirty:
            if src is not None:
                src.delete(tier, lease.key)
            self._release_lease(
                lease, "tombstone" if lease.tombstone else "superseded")
            return
        dest = self.groups[lease.dst]
        if lease.staged:
            val = lease.value
        else:
            val = src.get(tier, lease.key, linearizable=True).value
        dest.put(tier, lease.key, val)
        check = dest.get(tier, lease.key, linearizable=True)
        if not check.ok or check.value != val:  # pragma: no cover - safety
            raise RuntimeError(
                f"lease handoff verification failed for {lease.key!r}")
        if src is not None:
            src.delete(tier, lease.key)
        self._release_lease(lease, "copied")

    def _crash_lease_fixups(self, gid: str) -> None:
        """Deterministic lease resolution when ``gid`` crashes mid-handoff
        (called from :meth:`crash_group`, after the ring flipped):

        * destination crashed, lease dirty — the only fresh copy lived in
          the dead group's Raft; its §7.3 mirrors re-home it at promotion.
          The stale source copy is dropped NOW (it must not win), a
          tombstoned delete is recorded against the dead group's pending
          promotion, and the lease aborts.
        * destination crashed, lease pending — the value never left the
          source; the lease re-targets the key's new ring owner (or
          collapses entirely if the ring now points back at the source).
        * source crashed, lease dirty — the destination already holds the
          authoritative value (or tombstone); release, recording the
          tombstone against the source's pending promotion.
        * source crashed, lease pending — the value survives only in the
          source's mirrors; the lease aborts and promotion re-homes the
          key to its ring owner (the destination) later.
        """
        if not self.leases:
            return
        for lease in list(self.leases.active()):
            if lease.dst == gid:
                if lease.dirty:
                    src = (self.groups.get(lease.src)
                           if lease.src is not None else None)
                    if src is not None:
                        src.delete(GLOBAL, lease.key)
                    if lease.tombstone:
                        self.tombstones.setdefault(lease.key, set()).add(gid)
                    self._release_lease(lease, "aborted")
                else:
                    new_owner = self.gateways[
                        self.ring.locate(lease.key)].group.id
                    if new_owner == lease.src:
                        self._release_lease(lease, "returned")
                    else:
                        self.leases.retarget(lease.key, new_owner)
            elif lease.src == gid:
                if lease.dirty:
                    if lease.tombstone:
                        self.tombstones.setdefault(lease.key, set()).add(gid)
                    self._release_lease(
                        lease,
                        "tombstone" if lease.tombstone else "superseded")
                else:
                    self._release_lease(lease, "aborted")

    def _complete_lease_read(self, lease: MigrationLease) -> None:
        """A read hit a still-pending lease: complete this key's migration
        *now* (the per-key read barrier), so the read below answers from
        the authoritative destination. Dirty leases need nothing — the
        destination is already authoritative."""
        if lease.dirty or lease.tombstone:
            return
        self._resolve_lease(lease)

    def _local_lease_op(self, lease: MigrationLease, op: str, key: str,
                        value: Any, linearizable: bool) -> OpResult:
        """Client op on an adopted-local key mid-migration (satellite of
        the async drain): the lease destination is authoritative from
        acquisition, exactly like the global protocol — writes commit at
        the destination and mark the lease dirty (the stale source copy
        is discarded at resolution), deletes additionally tombstone, and
        a read of a still-pending lease pulls the key on demand first."""
        dst = self.groups[lease.dst]
        if op == "put":
            res = dst.put(LOCAL, key, value)
            if res.ok:
                lease.dirty = True
                lease.tombstone = False
            return res
        if op == "delete":
            res = dst.delete(LOCAL, key)
            if res.ok:
                lease.dirty = True
                lease.tombstone = True
            return res
        if not (lease.dirty or lease.tombstone):
            if self._lease_deferred(lease):
                # the pending value sits across an active cut: refuse
                # (counted unavailability) rather than answer stale
                self._count_refusal(
                    "get", self._quorum_side_of.get(lease.dst), "cross_cut")
                return OpResult(False)
            self._resolve_lease(lease)
        return dst.get(LOCAL, key, linearizable=linearizable)

    def _route_gateway(self, gw: "GatewayNode") -> "GatewayNode":
        """Routing entry point for a client's gateway: a draining gateway
        has left the overlay, so its clients route through the substitute
        recorded at drain time (its then-successor), falling back to any
        live ring member."""
        if gw.id in self.ring.nodes:
            return gw
        sub = self._drain_via.get(gw.id)
        if sub is not None and sub in self.ring.nodes:
            return self.gateways[sub]
        return next(g for g in self.gateways.values()
                    if g.id in self.ring.nodes)

    def _rewire_backups(self) -> None:
        """Re-apply the §7.3 successor rule after a membership change.

        Groups whose successor chain changed drop their learners and
        attach the new backups' nodes; a freshly attached learner is
        snapshot-seeded with the donor's current state (see
        attach_learners) — never backfilled from the historical log, which
        may contain migration tombstones for keys the learner's group now
        owns.
        """
        if not self._backup_groups:
            return
        from .backup import desired_backup_chains
        desired = desired_backup_chains(self)
        for gid, group in self.groups.items():
            want = desired.get(gid, [])
            if self.backup_chain.get(gid, []) == want and not (
                    not want and group.learner_ids):
                continue
            group.detach_learners()
            if not want:
                self.backup_of.pop(gid, None)
                self.backup_chain.pop(gid, None)
            else:
                for b in want:
                    group.attach_learners(self.groups[b])
                self.backup_of[gid] = want[0]
                self.backup_chain[gid] = list(want)

    def _migrate_key(self, src: EdgeGroup, dest: EdgeGroup, key: str) -> int:
        """Move one global key src -> dest through dest's Raft log."""
        val = src.get(GLOBAL, key, linearizable=True).value
        dest.put(GLOBAL, key, val)
        # linearizable read barrier at the new owner before dropping the
        # source copy: the handoff is complete only once a quorum at dest
        # serves the key.
        check = dest.get(GLOBAL, key, linearizable=True)
        if not check.ok or check.value != val:  # pragma: no cover - safety
            raise RuntimeError(f"handoff verification failed for {key!r}")
        src.delete(GLOBAL, key)
        return 1

    # ----------------------------------------------------- client interface
    def _owner_group(self, key: str, via_gateway: str) -> Tuple[EdgeGroup, List[str]]:
        gw = self.gateways[via_gateway]
        owner_gw, path = gw.locate(key)
        return self.gateways[owner_gw].group, path

    def put(self, key: str, value: Any, dtype: str, *, client_group: str) -> OpResult:
        """EdgeKV Algorithm 1 (placement) + Algorithm 2 (resource finder)."""
        from .placement import placement
        return placement(self, "put", key, value, dtype, client_group)

    def get(self, key: str, dtype: str, *, client_group: str,
            linearizable: bool = True) -> OpResult:
        from .placement import placement
        return placement(self, "get", key, None, dtype, client_group,
                         linearizable=linearizable)

    def delete(self, key: str, dtype: str, *, client_group: str) -> OpResult:
        from .placement import placement
        return placement(self, "delete", key, None, dtype, client_group)

    def handoff_pacer(self, *, batch: int = 64,
                      period: float = 0.05) -> "HandoffPacer":
        """A rate-limited :meth:`step_handoff` driver (see
        :class:`HandoffPacer`)."""
        return HandoffPacer(self, batch=batch, period=period)


class HandoffPacer:
    """Rate-limited driver for the async handoff: at most ``batch`` leases
    resolve per ``period`` seconds of virtual time, with every live
    group's Raft clock advanced between rounds — the core layer's mirror
    of the simulator's paced ``_drain_leases`` (batch + pause per round),
    so scenario scripts can drain without manual stepping.
    """

    def __init__(self, cluster: EdgeKVCluster, *, batch: int = 64,
                 period: float = 0.05):
        if batch < 1:
            raise ValueError("batch must be >= 1")
        if period < 0:
            raise ValueError("period must be >= 0")
        self.cluster = cluster
        self.batch = batch
        self.period = period
        self.now = 0.0
        self.rounds: List[Tuple[float, int]] = []  # (virtual t, resolved)

    def tick(self) -> int:
        """One pacing round: resolve up to ``batch`` leases, then advance
        every live group's virtual clock by ``period``. Returns the
        number of leases resolved this round."""
        n = self.cluster.step_handoff(self.batch)
        for group in self.cluster.groups.values():
            group.raft.step(self.period)
        self.now += self.period
        self.rounds.append((self.now, n))
        return n

    def drain(self, max_rounds: int = 100_000) -> int:
        """Tick until no pending lease remains. Stops early (instead of
        spinning) when a round resolves nothing — every remaining lease
        is deferred behind an active cut."""
        total = 0
        for _ in range(max_rounds):
            if not self.cluster.leases:
                break
            n = self.tick()
            total += n
            if n == 0:
                break
        return total

"""EdgeKV resource finder — Algorithm 2 of the paper.

Runs on gateway nodes: hash the key, locate the responsible gateway on the
Chord overlay, forward the request to that gateway's edge group, which
performs the quorum operation through its replication manager.

§7.3 failover rule: if the owner group is unreachable, **reads only** are
served from its backup group (which tracks the owner as a non-voting Raft
learner and may be slightly stale); writes fail until the owner returns, so
the two groups' states can never diverge.

Async handoff (per-key migration leases, :mod:`repro_torch.core.lease`): a key
under migration is *leased* to its destination group, which is
authoritative for it from lease acquisition on — regardless of where the
value physically sits. Writes commit at the destination (the stale source
copy is discarded at lease resolution, so nothing is applied twice);
deletes additionally tombstone the lease so the old value can never
resurrect; reads of a still-pending lease complete that key's migration on
demand (the read barrier, per key) before answering.
"""
from __future__ import annotations

from typing import Any, TYPE_CHECKING

from .kvstore import GLOBAL, OpResult

if TYPE_CHECKING:  # pragma: no cover
    from .kvstore import EdgeKVCluster, GatewayNode


def _owner(cluster: "EdgeKVCluster", gw: "GatewayNode", key: str):
    gw = cluster._route_gateway(gw)  # draining gateways route via substitute
    owner_gw_id, path = gw.locate(key)
    return cluster.gateways[owner_gw_id].group, owner_gw_id, path


def _leaseholder(cluster: "EdgeKVCluster", gw: "GatewayNode", key: str):
    """The destination group of ``key``'s active lease, if any — it is
    authoritative for the key while the migration is in flight."""
    lease = cluster.leases.get(key)
    if lease is None:
        return None, None
    return lease, cluster.groups[lease.dst]


def _partition_guard(cluster: "EdgeKVCluster", op: str, gw: "GatewayNode",
                     key: str):
    """Split-brain guard for a global op: resolve the key's authority (the
    active leaseholder, else the ring owner) and refuse — counted,
    non-mutating — when the client's side of the cut cannot reach it.
    NEVER falls back to a cross-cut backup mirror: that is exactly the
    stale-ack path a partition must close. Returns None when allowed."""
    if cluster.partition_of is None:
        return None
    lease = cluster.leases.get(key)
    if lease is not None:
        owner_gid = lease.dst
    else:
        owner_gid = _owner(cluster, gw, key)[0].id
    return cluster._partition_check(op, gw.group.id, owner_gid)


def _backup_read(cluster: "EdgeKVCluster", group, key: str, path) -> OpResult:
    """§7.3 failover: walk the unreachable owner's backup chain and serve
    the read from the first live mirror (serializable, possibly stale)."""
    chain = cluster.backup_chain.get(group.id) or (
        [cluster.backup_of[group.id]]
        if group.id in cluster.backup_of else [])
    for backup_gid in chain:
        backup = cluster.groups.get(backup_gid)
        if backup is None or not backup.reachable:
            continue
        res = backup.backup_get(group.id, GLOBAL, key)
        if not res.ok:
            continue
        res.from_backup = True  # type: ignore[attr-defined]
        res.dht_path = path  # type: ignore[attr-defined]
        return res
    return OpResult(False)


def resource_put(cluster: "EdgeKVCluster", gw: "GatewayNode", key: str,
                 value: Any) -> OpResult:
    refused = _partition_guard(cluster, "put", gw, key)
    if refused is not None:
        return refused
    lease, dst = _leaseholder(cluster, gw, key)
    if lease is not None:
        if not dst.reachable:
            # the leaseholder is partitioned: same rule as any owner —
            # the write fails (and the lease stays clean: nothing was
            # acknowledged, so nothing may supersede the source copy)
            return OpResult(False, value=None, leader=None)
        res = dst.put(GLOBAL, key, value)
        lease.dirty = True       # source copy superseded: never copied
        lease.tombstone = False  # a fresh write revokes a pending delete
        cluster.tombstones.pop(key, None)
        if cluster.hot_mirrors.pop(key, None) is not None:
            cluster.hot_stats["invalidated"] += 1  # mirror revoked on put
        res.dht_path = [gw.id, cluster.gateway_of_group[lease.dst]]  # type: ignore[attr-defined]
        res.leased = True  # type: ignore[attr-defined]
        return res
    group, owner_gw, path = _owner(cluster, gw, key)
    if not group.reachable:
        return OpResult(False, value=None, leader=None)  # writes must fail over partition
    res = group.put(GLOBAL, key, value)
    cluster.tombstones.pop(key, None)  # fresh write supersedes any tombstone
    if cluster.hot_mirrors.pop(key, None) is not None:
        cluster.hot_stats["invalidated"] += 1  # mirror revoked on put
    res.dht_path = path  # type: ignore[attr-defined]
    return res


def resource_get(cluster: "EdgeKVCluster", gw: "GatewayNode", key: str, *,
                 linearizable: bool = True) -> OpResult:
    refused = _partition_guard(cluster, "get", gw, key)
    if refused is not None:
        return refused
    lease, dst = _leaseholder(cluster, gw, key)
    if lease is not None:
        lease_path = [gw.id, cluster.gateway_of_group[dst.id]]
        if not dst.reachable:
            # partitioned leaseholder: a still-pending lease means the
            # authoritative value never left the source — serve it from
            # there (don't migrate INTO an unreachable group); a dirty
            # lease's value lives at the destination, so fall back to
            # its §7.3 backup mirror like any unreachable owner
            if not (lease.dirty or lease.tombstone):
                if lease.staged:
                    return OpResult(True, value=lease.value, quorum_size=1)
                src = cluster.groups.get(lease.src)
                if src is not None and src.reachable:
                    res = src.get(GLOBAL, key, linearizable=linearizable)
                    res.leased = True  # type: ignore[attr-defined]
                    return res
            return _backup_read(cluster, dst, key, lease_path)
        # per-key read barrier: a pending lease is completed on demand so
        # the destination answers authoritatively (dirty leases already are)
        if not (lease.dirty or lease.tombstone) and \
                cluster._lease_deferred(lease):
            # the pending value sits across an active cut — refuse
            # (counted unavailability) rather than pull through it
            cluster._count_refusal(
                "get", cluster._quorum_side_of.get(gw.group.id),
                "cross_cut")
            return OpResult(False)
        cluster._complete_lease_read(lease)
        res = dst.get(GLOBAL, key, linearizable=linearizable)
        res.dht_path = lease_path  # type: ignore[attr-defined]
        res.leased = True  # type: ignore[attr-defined]
        return res
    mirror = cluster.hot_mirrors.get(key)
    if mirror is not None:
        # hot-key mirror (§7.3 machinery repurposed for skew): a bounded
        # extra read replica served at the client's own gateway without a
        # quorum round — serializable, like a backup read. Revoke-on-put/
        # delete/lease keeps the copy equal to the owner's committed
        # value, so it can never serve a superseded or deleted key.
        mirror["hits"] += 1
        cluster.hot_stats["mirror_reads"] += 1
        res = OpResult(True, value=mirror["value"], quorum_size=1)
        res.from_mirror = True  # type: ignore[attr-defined]
        res.dht_path = [gw.id]  # type: ignore[attr-defined]
        return res
    group, owner_gw, path = _owner(cluster, gw, key)
    if not group.reachable:
        # §7.3: a backup serves READS ONLY, possibly stale ->
        # serializable, answered from the mirror it maintains for the
        # owner group. With backup_depth > 1 the chain is walked until a
        # member that is alive and holds the mirror answers.
        return _backup_read(cluster, group, key, path)
    res = group.get(GLOBAL, key, linearizable=linearizable)
    res.dht_path = path  # type: ignore[attr-defined]
    return res


def resource_delete(cluster: "EdgeKVCluster", gw: "GatewayNode",
                    key: str) -> OpResult:
    refused = _partition_guard(cluster, "delete", gw, key)
    if refused is not None:
        return refused
    lease, dst = _leaseholder(cluster, gw, key)
    if lease is not None:
        if not dst.reachable:
            # un-acknowledged delete must NOT tombstone the lease — the
            # source copy stays the only live one
            return OpResult(False)
        res = dst.delete(GLOBAL, key)
        lease.dirty = True
        lease.tombstone = True  # the delete wins over the source copy
        if cluster.hot_mirrors.pop(key, None) is not None:
            cluster.hot_stats["invalidated"] += 1  # mirror must not resurrect
        if cluster.dead_groups:
            # a pending mirror promotion must not resurrect the key either
            cluster.tombstones.setdefault(key, set()).update(
                cluster.dead_groups)
        res.dht_path = [gw.id, cluster.gateway_of_group[lease.dst]]  # type: ignore[attr-defined]
        res.leased = True  # type: ignore[attr-defined]
        return res
    group, owner_gw, path = _owner(cluster, gw, key)
    if not group.reachable:
        return OpResult(False)
    res = group.delete(GLOBAL, key)
    if cluster.hot_mirrors.pop(key, None) is not None:
        cluster.hot_stats["invalidated"] += 1  # mirror must not resurrect
    if cluster.dead_groups:
        # unavailability window: some group's keys survive only in §7.3
        # mirrors awaiting promotion. This delete (committed at the key's
        # current ring owner) must win over any of those pending mirror
        # copies — record a per-key tombstone tagged with every dead group
        # whose promotion it guards against.
        cluster.tombstones.setdefault(key, set()).update(
            cluster.dead_groups)
    res.dht_path = path  # type: ignore[attr-defined]
    return res

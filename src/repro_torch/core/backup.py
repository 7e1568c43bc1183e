"""EdgeKV backup groups (§7.3 inter-group fault tolerance).

Static assignment rule from the paper: the backup of a group is the first
group directly following its gateway on the overlay. The backup group's
nodes join the original group's Raft as **non-voting learners**: they
receive every AppendEntries and commit notification but are never counted
toward the quorum and never vote — so a slow or dead backup can't stall the
original group, and the backup can't diverge (it only ever applies entries
the original committed).

Beyond the paper, the rule generalizes to a *chain*: with
``backup_depth = d`` a group's mirrors live on its first ``d`` distinct
successor groups, so its state survives up to ``d`` overlapping crashes
(the single-backup paper rule is ``d = 1``). :func:`promote_backup`
implements the crash-recovery half: the first surviving chain member
donates its mirror, global keys re-home to their ring owners with the
linearizable read barrier, and local data is adopted under a namespaced
key range.
"""
from __future__ import annotations

from typing import Dict, List, TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from .kvstore import EdgeKVCluster

LOCAL, GLOBAL = "local", "global"

# Separator for promoted local keys: "<dead gid>::<key>" inside the
# adopting group's local store. Group ids never contain ':'.
PROMOTED_SEP = "::"


def desired_backup_chains(cluster: "EdgeKVCluster") -> Dict[str, List[str]]:
    """The §7.3 successor rule, chain-deep: each group's backups are the
    first ``backup_depth`` distinct groups following its gateway on the
    overlay. Single source of truth for initial wiring, elastic
    re-wiring, and post-crash re-wiring."""
    desired: Dict[str, List[str]] = {}
    if len(cluster.groups) < 2:
        return desired
    depth = cluster._backup_depth
    for gid, gw_id in cluster.gateway_of_group.items():
        if gw_id not in cluster.ring.nodes:
            continue  # draining group: off the overlay, keeps no backups
        chain = [cluster.gateways[gw].group.id
                 for gw in cluster.ring.successor_groups(gw_id, depth)]
        if chain:
            desired[gid] = chain
    return desired


def desired_backup_assignments(cluster: "EdgeKVCluster") -> Dict[str, str]:
    """First-successor view of :func:`desired_backup_chains` (the paper's
    single-backup rule)."""
    return {gid: chain[0]
            for gid, chain in desired_backup_chains(cluster).items()}


def assign_backup_groups(cluster: "EdgeKVCluster") -> None:
    """Wire every group's successor chain as its backups (learner sets)."""
    for gid, chain in desired_backup_chains(cluster).items():
        cluster.backup_of[gid] = chain[0]
        cluster.backup_chain[gid] = list(chain)
        for backup_gid in chain:
            cluster.groups[gid].attach_learners(cluster.groups[backup_gid])


def backup_lag(cluster: "EdgeKVCluster", gid: str) -> int:
    """Entries committed by ``gid`` but not yet applied at its backup.

    Used by tests and by the checkpoint mirror to decide whether a backup
    is fresh enough to restore from.
    """
    group = cluster.groups[gid]
    lead = group.raft.run_until_leader()
    if gid not in cluster.backup_of:
        return 0
    lag = 0
    for lid in group.learner_ids:
        learner = group.raft.nodes[lid]
        lag = max(lag, lead.commit_index - learner.last_applied)
    return lag


# ------------------------------------------------------------ promotion
def promote_backup(cluster: "EdgeKVCluster", dead_gid: str, *,
                   async_handoff: bool = False) -> int:
    """Crash-recovery promotion of a dead group's surviving mirror.

    1. Pick the most advanced live learner of the dead group (max Raft
       commit index, then log length) among the chain members that are
       still alive.
    2. Reconstruct the dead group's state: the learner's *applied* mirror
       plus the unapplied tail of its log — every entry acknowledged to a
       client had reached the learners' logs before the leader could
       commit it (the broadcast precedes the quorum count), so no
       acknowledged write is lost, and nothing from before the snapshot
       seed is replayed (no tombstone resurrection).
    3. Re-home global keys to their current ring owners through those
       owners' Raft logs with the linearizable read barrier. A key the
       new owner already holds was written *after* the crash and wins
       (the mirror copy is older by construction); a key the new owner
       *deleted* during the unavailability window carries a per-key
       tombstone (``cluster.tombstones``) that wins too — the mirror copy
       must not resurrect it. With ``async_handoff=True`` the surviving
       values are frozen onto *staged* migration leases instead of pushed
       synchronously (reads pull on demand, ``step_handoff`` drains the
       rest).
    4. Adopt local data into the promoting group under
       ``"<dead_gid>::<key>"`` committed through its Raft, and record the
       redirect so ``client_group=dead_gid`` local ops keep working.

    Returns the number of re-homed (or staged-leased) global keys.
    """
    from .kvstore import StorageModule

    group, chain = cluster.dead_groups[dead_gid]
    host_gid = next((b for b in chain if b in cluster.groups
                     and b not in cluster.draining), None)
    if host_gid is None:
        raise RuntimeError(
            f"cannot recover {dead_gid!r}: no member of its backup chain "
            f"{chain} survives")
    host = cluster.groups[host_gid]

    # most advanced live learner: its Raft node lives in the dead group's
    # raft, its host (and applied mirror) on the promoting group's nodes
    donors = [group.raft.nodes[lid] for lid in group.learner_ids
              if lid.split("@", 1)[0] in host.node_ids]
    if not donors:
        raise RuntimeError(
            f"{host_gid!r} holds no learner mirror for {dead_gid!r}")
    donor = max(donors, key=lambda n: (n.commit_index, len(n.log)))
    mirror = host.backup_storage[dead_gid][donor.id.split("@", 1)[0]]

    # applied state + unapplied log tail, into a scratch module (the
    # mirror itself is dropped once promotion completes)
    promoted = StorageModule()
    for tier, kv in mirror.stores.items():
        promoted.stores[tier].update(kv)
    for _, cmd in donor.log[donor.last_applied:]:
        promoted.apply(cmd)

    job = cluster._start_job("recover", dead_gid) if async_handoff else None
    moved = 0
    for key, val in promoted.stores[GLOBAL].items():
        ts = cluster.tombstones.get(key)
        if ts and dead_gid in ts:
            continue  # deleted at the new owner post-crash: tombstone wins
        owner_gw = cluster.ring.locate(key)
        dest = cluster.gateways[owner_gw].group
        check = dest.get(GLOBAL, key, linearizable=True)
        if check.ok and check.value is not None:
            continue  # post-crash write at the new owner wins
        if async_handoff:
            # stage the surviving value on a lease to its ring owner: the
            # value rides on the lease (the mirror is consumed below)
            cluster._acquire_lease(key, None, dest.id, job, value=val,
                                   staged=True)
            moved += 1
            continue
        dest.put(GLOBAL, key, val)
        verify = dest.get(GLOBAL, key, linearizable=True)
        if not verify.ok or verify.value != val:  # pragma: no cover
            raise RuntimeError(f"promotion verification failed for {key!r}")
        moved += 1
    # this dead group's promotion is decided: its tag on every tombstone
    # is consumed (a tombstone outlives only the promotions it guards)
    for key in list(cluster.tombstones):
        cluster.tombstones[key].discard(dead_gid)
        if not cluster.tombstones[key]:
            del cluster.tombstones[key]
    if job is not None:
        cluster._maybe_finalize(job)

    for key, val in promoted.stores[LOCAL].items():
        host.put(LOCAL, f"{dead_gid}{PROMOTED_SEP}{key}", val)
    cluster.promoted_local[dead_gid] = host_gid

    # the consumed mirrors are dropped everywhere: a dead group's stale
    # copies must not outlive the promotion (exactly-one-owner invariant)
    for b in chain:
        if b in cluster.groups:
            cluster.groups[b].backup_storage.pop(dead_gid, None)
    del cluster.dead_groups[dead_gid]
    return moved

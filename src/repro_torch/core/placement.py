"""EdgeKV placement protocol — Algorithm 1 of the paper.

``placement(key, value, type)``: *local* data is replicated inside the
client's own edge group (via its Raft leader); *global* data is forwarded to
the group's gateway node, whose resource finder (Algorithm 2) routes it over
the Chord overlay to the responsible group.
"""
from __future__ import annotations

from typing import Any, TYPE_CHECKING

from .resource_finder import resource_get, resource_put, resource_delete

if TYPE_CHECKING:  # pragma: no cover
    from .kvstore import EdgeKVCluster, OpResult

LOCAL, GLOBAL = "local", "global"


def placement(cluster: "EdgeKVCluster", op: str, key: str, value: Any,
              dtype: str, client_group: str, *,
              linearizable: bool = True) -> "OpResult":
    """Algorithm 1. The client's edge node decides by data type.

    Local ops never touch a gateway or the overlay; global ops go through
    the local gateway's resource finder.
    """
    if dtype not in (LOCAL, GLOBAL):
        raise ValueError(f"data type must be 'local' or 'global', got {dtype!r}")
    while client_group not in cluster.groups:
        # crashed-and-recovered group: its local data was promoted into a
        # surviving group under a namespaced key range (backup promotion,
        # §7.3) and stays addressable through the dead group id; global
        # ops route through the promoting group's gateway. The walk
        # follows the promotion *chain*: the adopting group may itself
        # have crashed later, re-namespacing the data one level deeper at
        # its own host.
        host_gid = cluster.promoted_local.get(client_group)
        if host_gid is None:
            raise KeyError(client_group)
        if dtype == LOCAL:
            from .backup import PROMOTED_SEP
            key = f"{client_group}{PROMOTED_SEP}{key}"
        client_group = host_gid
    group = cluster.groups[client_group]

    if dtype == LOCAL:
        # Split-brain guard: a straddled group with no quorum side refuses
        # writes and linearizable reads (counted, non-mutating) instead of
        # acking stale; serializable reads stay stale-by-contract.
        if op != "get" or linearizable:
            chk = cluster._partition_check(op, client_group, client_group)
            if chk is not None:
                return chk
        # Adopted-local key under an async-drain migration lease: the
        # lease destination is authoritative from acquisition (see
        # EdgeKVCluster._local_lease_op) — the promotion-pointer walk
        # above already landed us at the destination group.
        lease = cluster.leases.get(key)
        if lease is not None and lease.tier == LOCAL:
            return cluster._local_lease_op(lease, op, key, value,
                                           linearizable)
        # Lines 2-7: replicate inside the local group. EdgeGroup.put routes
        # through the Raft leader exactly as `send(Leader, ...)` does.
        if op == "put":
            return group.put(LOCAL, key, value)
        if op == "get":
            return group.get(LOCAL, key, linearizable=linearizable)
        if op == "delete":
            return group.delete(LOCAL, key)
        raise ValueError(op)

    # Lines 8-10: global -> send to the group's gateway (resource finder).
    gw = cluster.gateways[cluster.gateway_of_group[client_group]]
    if op == "put":
        return resource_put(cluster, gw, key, value)
    if op == "get":
        return resource_get(cluster, gw, key, linearizable=linearizable)
    if op == "delete":
        return resource_delete(cluster, gw, key)
    raise ValueError(op)

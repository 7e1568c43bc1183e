"""EdgeKV core — the paper's primary contribution, paper-faithful.

Two-tier decentralized KV storage: Raft-replicated edge groups (local
tier) stitched by a Chord consistent-hash overlay of gateway nodes
(global tier), with a typed placement protocol (local/global data),
backup groups, and gateway/edge caching.
"""
from .hashring import ChordRing, stable_hash
from .raft import RaftNode, LocalCluster, LEADER, FOLLOWER, CANDIDATE, LEARNER
from .kvstore import (EdgeGroup, EdgeKVCluster, GatewayNode, StorageModule,
                      OpResult, LOCAL, GLOBAL)
from .cache import LRUCache, EdgeDataCache
from .backup import assign_backup_groups, backup_lag
from .lease import LeaseTable, MigrationLease, OUTCOMES as LEASE_OUTCOMES

__all__ = [
    "ChordRing", "stable_hash", "RaftNode", "LocalCluster",
    "LEADER", "FOLLOWER", "CANDIDATE", "LEARNER",
    "EdgeGroup", "EdgeKVCluster", "GatewayNode", "StorageModule",
    "OpResult", "LOCAL", "GLOBAL", "LRUCache", "EdgeDataCache",
    "assign_backup_groups", "backup_lag",
    "LeaseTable", "MigrationLease", "LEASE_OUTCOMES",
]

"""Per-key migration leases for asynchronous handoff under live writes.

The synchronous cluster migrates key ranges *atomically* between client
operations (``EdgeKVCluster.add_group``/``remove_group``/``recover_group``
run their whole handoff before returning).  The async variant instead
*leases* every key whose owner changed to the destination group and lets
the handoff proceed incrementally — interleaved with client traffic —
with the lease table arbitrating who is authoritative meanwhile:

* The ring flips at lease **acquisition**: lookups route to the
  destination immediately, while the value may still physically live at
  the source.
* A **write** to a leased key commits at the destination's Raft log and
  marks the lease *dirty* — the stale source copy is discarded (never
  copied) when the lease resolves, so no acknowledged write is lost and
  no write is applied twice.
* A **delete** commits a delete at the destination and additionally sets
  the lease's *tombstone* — the delete wins over any later copy or
  mirror promotion of the old value.
* A **read** of a still-pending lease completes that key's migration on
  demand (pull: linearizable read at the source, commit at the
  destination, verify, delete at the source) and then answers from the
  destination — the paper's read barrier, per key instead of per range.
* ``EdgeKVCluster.step_handoff`` resolves pending leases in acquisition
  order (background migration); a crash mid-migration aborts or
  completes each affected lease deterministically from surviving state
  (see ``EdgeKVCluster.crash_group``).

States are deliberately minimal: a lease is *pending* until it is
released with one of the :data:`OUTCOMES` below; ``dirty``/``tombstone``
are monotonic flags a client op may set while the lease is active.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

#: Terminal outcomes a lease is released with.
#:
#: ``copied``      — the value was migrated src -> dst (by ``step_handoff``
#:                   or by a read pulling it on demand).
#: ``superseded``  — a client write at the destination made the source
#:                   copy stale; it was discarded, nothing was copied.
#: ``tombstone``   — a client delete at the destination won; the source
#:                   copy was discarded and must never resurrect.
#: ``returned``    — a crash re-pointed the ring back at the source; the
#:                   key never moved.
#: ``aborted``     — a crash killed the only party holding the pending
#:                   value; §7.3 mirror promotion owns the key's fate.
OUTCOMES = ("copied", "superseded", "tombstone", "returned", "aborted")


@dataclass
class MigrationLease:
    """One key under migration. ``src`` is the source group id, or ``None``
    for a staged recovery lease (the value then rides on the lease itself,
    frozen from the promoted §7.3 mirror)."""
    key: str
    src: Optional[str]
    dst: str
    seq: int
    job: Optional[int] = None
    dirty: bool = False
    tombstone: bool = False
    value: Any = None          # staged value (recovery leases only)
    staged: bool = False       # True when `value` is authoritative for src
    tier: str = "global"       # data tier the key lives in ("global"/"local")


class LeaseTable:
    """Cluster-wide table of active migration leases, keyed by key.

    At most one active lease per key; acquisition order (``seq``) is the
    deterministic background-resolution order. Released leases move to a
    bounded history with their outcome, and the ``stats`` counters let
    tests assert global lease accounting (every acquired lease is
    eventually released with a terminal outcome).
    """

    def __init__(self) -> None:
        self._leases: Dict[str, MigrationLease] = {}
        self._seq = 0
        self.history: List[Tuple[str, str]] = []  # (key, outcome)
        self.stats: Dict[str, int] = {"acquired": 0}
        for o in OUTCOMES:
            self.stats[o] = 0

    # ------------------------------------------------------------ lifecycle
    def acquire(self, key: str, src: Optional[str], dst: str, *,
                job: Optional[int] = None, value: Any = None,
                staged: bool = False, tier: str = "global") -> MigrationLease:
        if key in self._leases:
            raise RuntimeError(f"key {key!r} is already under migration "
                               f"(lease seq {self._leases[key].seq})")
        if src is None and not staged:
            raise ValueError("a lease without a source group must be staged")
        lease = MigrationLease(key, src, dst, self._seq, job=job,
                               value=value, staged=staged, tier=tier)
        self._seq += 1
        self._leases[key] = lease
        self.stats["acquired"] += 1
        return lease

    def release(self, key: str, outcome: str) -> MigrationLease:
        if outcome not in OUTCOMES:
            raise ValueError(f"unknown lease outcome {outcome!r}")
        lease = self._leases.pop(key)
        self.stats[outcome] += 1
        self.history.append((key, outcome))
        return lease

    def retarget(self, key: str, new_dst: str) -> MigrationLease:
        """Re-point a pending lease at a new destination (the old one
        crashed before the key moved)."""
        lease = self._leases[key]
        if lease.dirty:
            raise RuntimeError(
                f"cannot retarget dirty lease for {key!r}: the fresh value "
                "lives at the old destination")
        lease.dst = new_dst
        return lease

    # ------------------------------------------------------------- queries
    def get(self, key: str) -> Optional[MigrationLease]:
        return self._leases.get(key)

    def active(self) -> Iterator[MigrationLease]:
        """Active leases in acquisition order (the deterministic
        background-resolution order). Dict insertion order IS seq order:
        acquire only appends, release pops, and retarget never reorders —
        so no sort is needed (paced drains call this once per batch)."""
        return iter(list(self._leases.values()))

    def __len__(self) -> int:
        return len(self._leases)

    def __bool__(self) -> bool:
        return bool(self._leases)

    def __contains__(self, key: str) -> bool:
        return key in self._leases

    def balanced(self) -> bool:
        """Accounting invariant: every acquired lease is active or was
        released with exactly one terminal outcome."""
        done = sum(self.stats[o] for o in OUTCOMES)
        return self.stats["acquired"] == done + len(self._leases)

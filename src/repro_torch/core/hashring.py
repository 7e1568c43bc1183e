"""Chord-style consistent-hash ring with finger tables and virtual nodes.

Faithful to EdgeKV §3.1/§3.2.3: gateway nodes live on a 2**BITS identifier
ring; a key is owned by its *successor* gateway. Lookup uses the optimized
iterative closest-preceding-finger algorithm of Stoica et al. (the paper's
[17]), giving O(log m) hops and O(log m) routing state per node. Virtual
nodes (§7.1) improve load balance; weights let powerful groups own more of
the key space.

The ring is a *control-plane* structure: pure Python, deterministic, no JAX.
It is shared by the paper-faithful reproduction (``core/kvstore.py``,
``sim/``) and by the framework features (``checkpoint/manifest.py``,
``edgecache/pages.py``).
"""
from __future__ import annotations

import bisect
import hashlib
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

BITS = 64
RING_SIZE = 1 << BITS


def stable_hash(key: str, salt: str = "") -> int:
    """Collision-resistant, process-stable hash onto the identifier ring."""
    h = hashlib.sha1((salt + key).encode("utf-8")).digest()
    return int.from_bytes(h[:8], "big") % RING_SIZE


def _in_open_interval(x: int, a: int, b: int) -> bool:
    """x in (a, b) on the ring (wrapping)."""
    if a < b:
        return a < x < b
    return x > a or x < b  # interval wraps through 0


@dataclass
class VirtualNode:
    vhash: int
    owner: str  # physical node id


@dataclass
class FingerEntry:
    start: int
    node: int  # vnode hash of successor(start)


class ChordRing:
    """Consistent-hash ring over named physical nodes.

    Parameters
    ----------
    virtual_nodes:
        Base number of virtual nodes per physical node (§7.1 suggests
        ~log(N)). Per-node ``weights`` multiply this count.
    """

    def __init__(self, virtual_nodes: int = 1, successors: int = 4):
        self.base_vnodes = max(1, int(virtual_nodes))
        self.succ_depth = max(1, int(successors))
        self.weights: Dict[str, float] = {}
        self._vhashes: List[int] = []       # sorted virtual hashes
        self._vowners: List[str] = []       # parallel owner ids
        self.nodes: Dict[str, List[int]] = {}  # physical id -> its vhashes
        self._fingers: Dict[int, List[FingerEntry]] = {}
        # Chord §E.3 successor lists: per vnode, the vnodes of the next
        # `succ_depth` *distinct* physical owners clockwise. A planned
        # membership event refreshes them synchronously; an abrupt crash
        # leaves dead entries behind for stabilize() to repair.
        self._succ_lists: Dict[int, List[int]] = {}
        # vnodes of crashed nodes awaiting stabilization: still referenced
        # by finger tables and successor lists, but owner-less and skipped
        # by routing (a live Chord node times out on them and tries the
        # next finger / successor-list entry)
        self._dead: Set[int] = set()
        # churn instrumentation: tests assert add/remove never trigger a
        # from-scratch rebuild once the incremental path is in place
        self.finger_rebuilds = 0
        self.incremental_updates = 0
        self.crashes = 0
        self.stabilize_repairs = 0  # succ-list entries repaired by stabilize()
        self.finger_repairs = 0     # finger entries repaired by fix_fingers()

    # ------------------------------------------------------------- topology
    def _vnode_count(self, weight: float) -> int:
        """Vnode count for ``weight`` with explicit half-up rounding.

        Python's ``round`` uses banker's rounding (half-to-even), which
        maps halfway weights non-monotonically — e.g. with
        ``base_vnodes=1``, weight 2.5 -> 2 vnodes but weight 1.5 -> 2 as
        well, so a strictly larger weight could yield the same or fewer
        vnodes. Floor-plus-half keeps counts monotone in the weight.
        """
        if weight <= 0:
            raise ValueError(f"weight must be positive, got {weight}")
        return max(1, int(self.base_vnodes * weight + 0.5))

    def _vnode_hashes(self, node_id: str, lo: int, hi: int) -> List[int]:
        """Deterministic vnode hashes for suffix indices ``[lo, hi)``.

        The hash is a pure function of (node_id, index), so growing or
        shrinking a node's vnode count touches exactly the suffix —
        the incremental-reweight delta the caller adds/removes."""
        vhashes: List[int] = []
        for i in range(lo, hi):
            vh = stable_hash(node_id, salt=f"vnode-{i}:")
            # linear-probe extremely unlikely collisions deterministically
            while vh in self._vhashes or vh in vhashes:
                vh = (vh + 1) % RING_SIZE
            vhashes.append(vh)
        return vhashes

    def _drop_weight(self, node_id: str) -> None:
        """Single teardown point for a departing node's weight entry —
        remove/crash/reweight all route through here so a reweight can
        never observe (or leak) a stale weight."""
        self.weights.pop(node_id, None)

    def add_node(self, node_id: str, weight: float = 1.0) -> None:
        if node_id in self.nodes:
            raise ValueError(f"node {node_id!r} already in ring")
        vhashes = self._vnode_hashes(node_id, 0, self._vnode_count(weight))
        self.nodes[node_id] = vhashes
        self.weights[node_id] = weight
        for vh in vhashes:
            idx = bisect.bisect_left(self._vhashes, vh)
            self._vhashes.insert(idx, vh)
            self._vowners.insert(idx, node_id)
        self._fingers_after_add(vhashes)
        self._refresh_succ_lists()

    def reweight_node(self, node_id: str,
                      weight: float) -> Tuple[List[int], List[int]]:
        """Change ``node_id``'s weight in place, incrementally.

        Vnode hashes are a pure function of (node_id, index), so moving
        from ``c1`` to ``c2`` vnodes adds exactly the suffix ``[c1, c2)``
        or removes exactly ``[c2, c1)`` — only the delta touches the
        sorted ring arrays and finger tables (same patch rules as a
        planned join/leave; equivalence-tested against a full rebuild).
        Returns ``(added_vhashes, removed_vhashes)``; both empty when the
        new weight maps to the same vnode count (no key can move).
        """
        if node_id not in self.nodes:
            raise KeyError(node_id)
        vhashes = self.nodes[node_id]
        c1, c2 = len(vhashes), self._vnode_count(weight)
        self.weights[node_id] = weight
        if c2 > c1:
            added = self._vnode_hashes(node_id, c1, c2)
            vhashes.extend(added)
            for vh in added:
                idx = bisect.bisect_left(self._vhashes, vh)
                self._vhashes.insert(idx, vh)
                self._vowners.insert(idx, node_id)
            self._fingers_after_add(added)
            self._refresh_succ_lists()
            return added, []
        if c2 < c1:
            removed = vhashes[c2:]
            del vhashes[c2:]
            for vh in removed:
                idx = bisect.bisect_left(self._vhashes, vh)
                del self._vhashes[idx]
                del self._vowners[idx]
            for vh in removed:
                self._fingers.pop(vh, None)
                self._succ_lists.pop(vh, None)
            self._fingers_after_remove(removed)
            self._refresh_succ_lists()
            return [], removed
        return [], []

    def remove_node(self, node_id: str) -> None:
        """Planned departure: the node says goodbye and routing state is
        repaired synchronously (fingers incrementally, successor lists by
        refresh). Unlike :meth:`crash_node` this is always safe — the
        departing node participates in the repair."""
        if node_id not in self.nodes:
            raise KeyError(node_id)
        removed = self.nodes.pop(node_id)
        for vh in removed:
            idx = bisect.bisect_left(self._vhashes, vh)
            del self._vhashes[idx]
            del self._vowners[idx]
        self._drop_weight(node_id)
        self._fingers_after_remove(removed)
        self._refresh_succ_lists()

    # ------------------------------------------------- crash + stabilization
    def crash_node(self, node_id: str) -> List[int]:
        """Abrupt, unplanned loss of ``node_id`` — no goodbye protocol.

        The node's vnodes leave the ownership arrays immediately (its key
        range transfers to the successors), but finger tables and successor
        lists still reference the dead vnodes: routing skips them (the
        remote peer would time out) until :meth:`stabilize` and
        :meth:`fix_fingers` repair the state. Raises instead of corrupting
        the ring when the loss is not survivable:

        * crashing the last live node leaves nobody to serve the key
          space (so in a 2-node ring the first crash collapses to a
          valid singleton — §7.3 promotion needs that — and the
          survivor, now the last member, refuses to crash);
        * crashing a node whose death completes the death of some live
          vnode's entire r-deep successor chain (i.e. more than
          ``succ_depth - 1`` un-stabilized simultaneous crashes) would
          disconnect that vnode from the ring.
        """
        if node_id not in self.nodes:
            raise KeyError(node_id)
        if len(self.nodes) == 1:
            raise RuntimeError(
                f"cannot crash {node_id!r}: it is the last live node of "
                "the ring (no successor could take over its key range)")
        victims = set(self.nodes[node_id])
        dead_after = self._dead | victims
        if len(self.nodes) > 2:
            # survivability: every live vnode must keep at least one live
            # entry in its successor chain (a 2-node ring collapses to a
            # valid singleton instead, its survivor owning everything)
            for vh, chain in self._succ_lists.items():
                if vh in dead_after:
                    continue
                if chain and all(s in dead_after for s in chain):
                    raise RuntimeError(
                        f"cannot crash {node_id!r}: it is the entire "
                        f"remaining successor chain of vnode {vh} — more "
                        f"than {self.succ_depth - 1} simultaneous crashes "
                        "since the last stabilize() round")
        removed = self.nodes.pop(node_id)
        for vh in removed:
            idx = bisect.bisect_left(self._vhashes, vh)
            del self._vhashes[idx]
            del self._vowners[idx]
        self._drop_weight(node_id)
        # the dead node's own routing state dies with it; everyone else's
        # stale references remain until the periodic repair runs
        for vh in removed:
            self._fingers.pop(vh, None)
            self._succ_lists.pop(vh, None)
        self._dead |= set(removed)
        self.crashes += 1
        return removed

    @property
    def stabilized(self) -> bool:
        """True when no routing state references a crashed vnode."""
        return not self._dead

    def stabilize(self) -> int:
        """One Chord stabilization round: every live vnode re-validates its
        successor chain, dropping dead entries and re-extending the list
        from its first live successor. Returns the number of repaired
        entries. Idempotent; O(V · r) per round, never a full rebuild."""
        repaired = 0
        dead = self._dead
        for vh, chain in self._succ_lists.items():
            if dead and any(s in dead for s in chain):
                repaired += sum(1 for s in chain if s in dead)
                self._succ_lists[vh] = self._succ_list_for(vh)
            elif len(chain) < self._max_chain_len():
                # refill a short chain (earlier crash consumed entries)
                fresh = self._succ_list_for(vh)
                repaired += len(fresh) - len(chain)
                self._succ_lists[vh] = fresh
        self.stabilize_repairs += repaired
        self._maybe_clear_dead()
        return repaired

    def fix_fingers(self) -> int:
        """Periodic finger repair: re-resolve every finger entry that
        points at a crashed vnode against the live ring (the same patch
        rule as a planned removal, run lazily). Returns the number of
        entries repaired."""
        if not self._dead:
            return 0
        repaired = 0
        dead = self._dead
        for entries in self._fingers.values():
            for e in entries:
                if e.node in dead:
                    e.node = self._succ_vhash(e.start)
                    repaired += 1
        self.finger_repairs += repaired
        self._maybe_clear_dead()
        return repaired

    def _maybe_clear_dead(self) -> None:
        if not self._dead:
            return
        dead = self._dead
        for entries in self._fingers.values():
            for e in entries:
                if e.node in dead:
                    return
        for chain in self._succ_lists.values():
            if any(s in dead for s in chain):
                return
        self._dead = set()

    def _max_chain_len(self) -> int:
        """Longest possible distinct-owner chain with current membership."""
        return min(self.succ_depth, max(0, len(self.nodes) - 1))

    def _succ_list_for(self, vh: int) -> List[int]:
        """Oracle successor chain for one vnode: the vnodes of the next
        ``succ_depth`` distinct live physical owners walking clockwise
        (excluding the vnode's own owner)."""
        if not self._vhashes:
            return []
        idx = bisect.bisect_left(self._vhashes, vh)
        n = len(self._vhashes)
        own = self._vowners[idx] if idx < n and self._vhashes[idx] == vh \
            else self.successor(vh)
        chain: List[int] = []
        seen = {own}
        for step in range(1, n + 1):
            j = (idx + step) % n
            owner = self._vowners[j]
            if owner not in seen:
                seen.add(owner)
                chain.append(self._vhashes[j])
                if len(chain) == self.succ_depth:
                    break
        return chain

    def _refresh_succ_lists(self) -> None:
        """Recompute every live vnode's successor chain (planned membership
        events repair synchronously; cost O(V · r), far below the V · BITS
        of a finger rebuild)."""
        self._succ_lists = {vh: self._succ_list_for(vh)
                            for vh in self._vhashes if vh not in self._dead}

    def successor_list(self, node_id: str) -> Dict[int, List[str]]:
        """Per-vnode successor chains of ``node_id`` as physical owners
        (diagnostics / tests)."""
        out = {}
        for vh in self.nodes[node_id]:
            owners = []
            for s in self._succ_lists.get(vh, []):
                if s in self._dead:
                    owners.append(None)  # dead, pending stabilization
                else:
                    owners.append(self._vowners[
                        bisect.bisect_left(self._vhashes, s)])
            out[vh] = owners
        return out

    # -------------------------------------------------------------- lookup
    def successor(self, point: int) -> str:
        """Physical owner of identifier ``point`` (its successor vnode)."""
        if not self._vhashes:
            raise RuntimeError("empty ring")
        idx = bisect.bisect_left(self._vhashes, point % RING_SIZE)
        if idx == len(self._vhashes):
            idx = 0
        return self._vowners[idx]

    def locate(self, key: str) -> str:
        """Responsible physical node for ``key`` (EdgeKV Algorithm 2)."""
        return self.successor(stable_hash(key))

    def locate_hash(self, key_hash: int) -> str:
        return self.successor(key_hash)

    # Finger-table routing -- used to *verify* the O(log m) hop bound and to
    # model per-hop latency in the simulator. Data-plane callers use
    # ``locate`` directly (one control-plane computation).
    def _rebuild_fingers(self) -> None:
        self.finger_rebuilds += 1
        self._fingers.clear()
        if not self._vhashes:
            return
        for vh in self._vhashes:
            self._fingers[vh] = self._fresh_table(vh)

    def _fresh_table(self, vh: int) -> List[FingerEntry]:
        entries = []
        for i in range(BITS):
            start = (vh + (1 << i)) % RING_SIZE
            entries.append(FingerEntry(start, self._succ_vhash(start)))
        return entries

    # Incremental maintenance (Chord §4 join/leave, batched per physical
    # node). A membership event touches O(V·BITS) finger entries instead of
    # recomputing all V·BITS entries with a bisect each — the from-scratch
    # rebuild is kept only as the test oracle.
    def _fingers_after_add(self, new_vhashes: List[int]) -> None:
        self.incremental_updates += 1
        # 1. the new vnodes need full tables (the sorted ring lists already
        #    contain them, so _succ_vhash sees the final membership)
        for vh in new_vhashes:
            self._fingers[vh] = self._fresh_table(vh)
        # 2. an existing finger [start -> node] is redirected iff one of the
        #    new vnodes lies in [start, node) — i.e. it is now the closer
        #    successor of start. Clockwise distances make the wrap explicit.
        new_sorted = sorted(new_vhashes)
        new_set = set(new_vhashes)
        n_new = len(new_sorted)
        for vh, entries in self._fingers.items():
            if vh in new_set:
                continue  # freshly built above
            for e in entries:
                i = bisect.bisect_left(new_sorted, e.start)
                cand = new_sorted[i % n_new]  # first new vnode clockwise
                if (cand - e.start) % RING_SIZE < (e.node - e.start) % RING_SIZE:
                    e.node = cand

    def _fingers_after_remove(self, removed_vhashes: List[int]) -> None:
        self.incremental_updates += 1
        for vh in removed_vhashes:
            self._fingers.pop(vh, None)
        if not self._vhashes:
            self._fingers.clear()
            return
        # only entries that pointed at a departed vnode need re-resolving
        removed = set(removed_vhashes)
        for entries in self._fingers.values():
            for e in entries:
                if e.node in removed:
                    e.node = self._succ_vhash(e.start)

    def _succ_vhash(self, point: int) -> int:
        idx = bisect.bisect_left(self._vhashes, point % RING_SIZE)
        if idx == len(self._vhashes):
            idx = 0
        return self._vhashes[idx]

    def _closest_preceding(self, from_vh: int, target: int) -> int:
        # Uses the precomputed FingerEntry.node (kept fresh by incremental
        # maintenance) — no per-finger bisect on the hot routing path.
        # Fingers referencing crashed vnodes are skipped (the live node
        # would time out on them and fall through to the next finger),
        # so lookups keep converging on an un-stabilized ring.
        fingers = self._fingers[from_vh]
        dead = self._dead
        for entry in reversed(fingers):
            if dead and entry.node in dead:
                continue
            if _in_open_interval(entry.node, from_vh, target):
                return entry.node
        return from_vh

    def route(self, start_node: str, key: str) -> List[str]:
        """Chord iterative lookup path from ``start_node`` to key's owner.

        Returns the sequence of *physical* nodes contacted (including the
        start and the final owner). Length is O(log m) w.h.p.
        """
        if start_node not in self.nodes:
            raise KeyError(start_node)
        target = stable_hash(key)
        # A Chord node knows its predecessor: if the key falls in
        # (pred, self] the lookup terminates locally with zero hops — the
        # paper's gateway 'first checks if the key belongs to this edge
        # group' (§5.4.1).
        if self.successor(target) == start_node:
            return [start_node]
        cur = self.nodes[start_node][0]
        path = [start_node]
        # iterate until cur's successor owns target: target in (cur, succ].
        # The bound covers the worst case on an un-stabilized ring, where
        # dead fingers force successor-hop fallbacks.
        for _ in range(2 * BITS + len(self._vhashes)):
            succ = self._succ_vhash((cur + 1) % RING_SIZE)
            if _in_open_interval(target, cur, succ) or target == succ:
                owner = self._vowners[bisect.bisect_left(self._vhashes, succ)]
                if path[-1] != owner:
                    path.append(owner)
                return path
            nxt = self._closest_preceding(cur, target)
            if nxt == cur:
                if not self._dead:
                    # healthy fingers: no closer hop -> successor owns it
                    owner = self._vowners[
                        bisect.bisect_left(self._vhashes, succ)]
                    if path[-1] != owner:
                        path.append(owner)
                    return path
                # un-stabilized ring: every closer finger was dead — fall
                # back to the successor hop (Chord's stabilize-era rule:
                # the successor pointer keeps lookups correct, fingers
                # only make them fast)
                nxt = succ
            cur = nxt
            owner = self._vowners[bisect.bisect_left(self._vhashes, cur)]
            if path[-1] != owner:
                path.append(owner)
        raise RuntimeError("chord lookup did not converge")

    # ---------------------------------------------------------- utilities
    def key_distribution(self, keys: Iterable[str]) -> Dict[str, int]:
        counts = {n: 0 for n in self.nodes}
        for k in keys:
            counts[self.locate(k)] += 1
        return counts

    def moved_keys(self, keys: Sequence[str], other: "ChordRing") -> int:
        """How many of ``keys`` map to a different owner in ``other``."""
        return sum(1 for k in keys if self.locate(k) != other.locate(k))

    def finger_table_size(self, node_id: str) -> int:
        """Distinct routing-state entries held by ``node_id``.

        Chord stores BITS fingers per vnode but most point at the same
        successor — the *distinct* count is O(log m), which the tests
        assert."""
        return sum(
            len({e.node for e in self._fingers[vh]})
            for vh in self.nodes[node_id]
        )

    def preference_list(self, key: str, n: int) -> List[str]:
        """First ``n`` distinct physical owners walking the ring clockwise
        from the key's position — the replica set used by quorum
        checkpointing (Dynamo-style preference list on Chord)."""
        if not self._vhashes:
            raise RuntimeError("empty ring")
        idx = bisect.bisect_left(self._vhashes, stable_hash(key))
        out: List[str] = []
        total = len(self._vhashes)
        for step in range(total):
            owner = self._vowners[(idx + step) % total]
            if owner not in out:
                out.append(owner)
                if len(out) == n:
                    break
        return out

    def successor_groups(self, node_id: str, count: int) -> List[str]:
        """First ``count`` distinct physical nodes following ``node_id``
        on the ring (excluding itself), walking clockwise from its first
        vnode — the chain-deep generalization of EdgeKV §7.3's static
        backup-group assignment rule. Shorter when the ring has fewer
        other nodes."""
        vh = self.nodes[node_id][0]
        idx = bisect.bisect_left(self._vhashes, vh)
        n = len(self._vhashes)
        out: List[str] = []
        seen = {node_id}
        for step in range(1, n + 1):
            owner = self._vowners[(idx + step) % n]
            if owner not in seen:
                seen.add(owner)
                out.append(owner)
                if len(out) == count:
                    break
        return out

    def successor_group(self, node_id: str) -> str:
        """First distinct physical node following ``node_id`` on the ring —
        EdgeKV §7.3's static backup-group assignment rule."""
        if len(self.nodes) < 2:
            raise RuntimeError("need >= 2 nodes for a backup assignment")
        return self.successor_groups(node_id, 1)[0]

    def __len__(self) -> int:
        return len(self.nodes)

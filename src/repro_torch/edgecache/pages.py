"""Two-tier EdgeKV page store for serving: the paper's placement protocol
applied to transformer KV pages.

* **Local tier** — a sequence's own KV pages. Owned by the serving group
  (the data-parallel slice hosting the sequence), never on the ring:
  EdgeKV local data (§3.2.2).
* **Global tier** — content-hash-keyed shared pages (system prompts,
  few-shot preambles). Deduplicated; placement over groups via the
  consistent-hash ring with weighted virtual nodes (§3.1, §7.1); hot pages
  may be cached locally (§7.2, serializable reads are safe because global
  pages are immutable — content-addressed).

The manager is host-side control plane; the data plane is the int32 page
tables consumed by ``kernels/paged_attention``.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.hashring import ChordRing
from repro_torch.core.cache import LRUCache


def content_key(token_ids: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(token_ids).tobytes()).hexdigest()


@dataclass
class PageRef:
    slot: int            # index into the device page pool
    tier: str            # 'local' | 'global'
    owner_group: str     # serving group (local) or ring owner (global)
    key: str = ""        # content hash for global pages


class PagePoolManager:
    """Allocates pool slots; tracks per-sequence page lists and the global
    dedup index. One manager per serving group; ring shared by all."""

    def __init__(self, group_id: str, n_slots: int, page_size: int,
                 ring: ChordRing, *, hot_cache: int = 64):
        self.group = group_id
        self.page_size = page_size
        self.n_slots = n_slots
        self.free: List[int] = list(range(n_slots))[::-1]
        self.seq_pages: Dict[str, List[PageRef]] = {}
        self.global_index: Dict[str, PageRef] = {}   # content key -> ref
        self.global_refcount: Dict[str, int] = {}
        self.ring = ring
        self.hot_cache = LRUCache(hot_cache)
        self.stats = {"alloc": 0, "dedup_hits": 0, "remote_fetch": 0,
                      "evicted": 0}

    # ------------------------------------------------------------- local
    def alloc_local(self, seq_id: str, n_pages: int) -> List[PageRef]:
        refs = []
        for _ in range(n_pages):
            slot = self._take_slot()
            ref = PageRef(slot, "local", self.group)
            refs.append(ref)
            self.seq_pages.setdefault(seq_id, []).append(ref)
        return refs

    # ------------------------------------------------------------ global
    def register_global(self, seq_id: str, prefix_tokens: np.ndarray
                        ) -> List[PageRef]:
        """Register a shared prefix; returns page refs (deduplicated).

        Pages are keyed per page_size chunk of the prefix; the ring decides
        the owner group of each chunk. If we own it (or already cached it),
        no transfer; else it's a remote fetch (counted for the bench).
        """
        refs = []
        n = len(prefix_tokens)
        for i in range(0, n, self.page_size):
            chunk = prefix_tokens[i:i + self.page_size]
            key = content_key(chunk)
            if key in self.global_index:
                self.stats["dedup_hits"] += 1
                ref = self.global_index[key]
            else:
                owner = self.ring.locate(key)
                if owner != self.group and self.hot_cache.get(key) is None:
                    self.stats["remote_fetch"] += 1
                    self.hot_cache.put(key, True)
                slot = self._take_slot()
                ref = PageRef(slot, "global", owner, key)
                self.global_index[key] = ref
            self.global_refcount[key] = self.global_refcount.get(key, 0) + 1
            self.seq_pages.setdefault(seq_id, []).append(ref)
            refs.append(ref)
        return refs

    # ---------------------------------------------------------- lifecycle
    def release(self, seq_id: str) -> None:
        for ref in self.seq_pages.pop(seq_id, []):
            if ref.tier == "local":
                self.free.append(ref.slot)
            else:
                self.global_refcount[ref.key] -= 1
                if self.global_refcount[ref.key] == 0:
                    self.free.append(ref.slot)
                    del self.global_index[ref.key]
                    del self.global_refcount[ref.key]
                    self.stats["evicted"] += 1

    def page_table(self, seq_id: str, max_pages: int) -> np.ndarray:
        refs = self.seq_pages.get(seq_id, [])
        pt = np.zeros((max_pages,), np.int32)
        for i, r in enumerate(refs[:max_pages]):
            pt[i] = r.slot
        return pt

    def _take_slot(self) -> int:
        if not self.free:
            raise RuntimeError("page pool exhausted")
        self.stats["alloc"] += 1
        return self.free.pop()

    @property
    def used_slots(self) -> int:
        return self.n_slots - len(self.free)

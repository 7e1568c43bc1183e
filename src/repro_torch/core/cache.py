"""EdgeKV caching (§7.2): gateway location cache + edge data cache.

Two caches with different consistency rules, exactly as the paper draws
them:

* **Gateway location cache** — memoizes ``key -> responsible gateway`` so a
  hot key skips the O(log m) Chord traversal. Locations are invalidated on
  ring membership change (consistent hashing moves only K/m keys; we simply
  clear, since correctness is re-established by the next lookup).
* **Edge data cache** — caches *global* key-value pairs near the client.
  Linearizable reads must still revalidate with the owner group (the cache
  only saves the value transfer, not the consistency round); serializable
  reads may answer straight from cache and tolerate staleness.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Optional, Tuple


class LRUCache:
    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._d: "OrderedDict[str, Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: str) -> Optional[Any]:
        if key in self._d:
            self._d.move_to_end(key)
            self.hits += 1
            return self._d[key]
        self.misses += 1
        return None

    def put(self, key: str, value: Any) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def invalidate(self, key: Optional[str] = None) -> None:
        if key is None:
            self._d.clear()
        else:
            self._d.pop(key, None)

    def __len__(self) -> int:
        return len(self._d)


class EdgeDataCache:
    """Global-data cache at an edge node with the §7.2 consistency rule."""

    def __init__(self, capacity: int):
        self.values = LRUCache(capacity)
        self.versions = LRUCache(capacity)

    def read(self, key: str, *, linearizable: bool,
             fetch_version, fetch_value) -> Tuple[Any, bool]:
        """Returns (value, served_from_cache).

        ``fetch_version()`` performs the cheap remote validation round (the
        consistency check the paper says linearizable cached reads still
        pay); ``fetch_value()`` performs the full remote read.
        """
        cached = self.values.get(key)
        if cached is None:
            value, version = fetch_value()
            self.values.put(key, value)
            self.versions.put(key, version)
            return value, False
        if not linearizable:
            return cached, True  # stale tolerated
        version = fetch_version()
        if version == self.versions.get(key):
            return cached, True  # validated: cache is current
        value, version = fetch_value()
        self.values.put(key, value)
        self.versions.put(key, version)
        return value, False

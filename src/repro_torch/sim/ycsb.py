"""YCSB-style workload generation (paper §5.2.3).

Workload A: 50% reads / 50% updates over a preloaded key space (10,000
records by default, ~1 KB values — YCSB's 10 fields x 100 B). Request
distributions reproduced as the paper configures them:

* ``uniform`` — every key equally likely.
* ``zipfian`` — the paper's hotset configuration: 20% of the keys (chosen
  at random) receive 80% of the operations.
* ``latest`` — recently inserted keys are more popular; popularity decays
  zipf-like with recency rank.

Each generated op also draws a *data type*: global with probability
``p_global`` (the paper's 'proportion of global data' parameter), else
local — mirroring the paper's modified YCSB database-interface layer that
stores every pair in both tiers and randomly targets one per request.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

RECORD_BYTES = 1000  # YCSB default record size
REQ_BYTES = 64       # request header / key

# integer codes shared by the batched schedules, the SoA record buffer and
# the vectorized engine (repro_torch.sim.records / repro_torch.sim.vectorized)
KINDS = ("read", "update", "insert")
DTYPES = ("local", "global")
KIND_CODE = {k: i for i, k in enumerate(KINDS)}
DTYPE_CODE = {d: i for i, d in enumerate(DTYPES)}


_KEY_CACHE: dict = {}
_STATE_CACHE: dict = {}


def _key_strings(n: int) -> List[str]:
    """YCSB key space (shared & memoized — every workload with the same
    ``n_records`` uses the identical key list)."""
    keys = _KEY_CACHE.get(n)
    if keys is None:
        keys = _KEY_CACHE[n] = [f"user{i:08d}" for i in range(n)]
    return keys


def _derived_state(seed: int, n_records: int, hotset_frac: float,
                   zipf_s: float) -> tuple:
    """Seed-derived sampling state (hotset permutation, zipf CDF), shared
    read-only across workload instances.  Sweep grids instantiate the
    same (seed, keyspace) workload once per grid point; memoizing keeps
    workload construction out of the per-point cost for every engine."""
    ck = (seed, n_records, hotset_frac, zipf_s)
    st = _STATE_CACHE.get(ck)
    if st is None:
        order = np.random.default_rng(
            np.random.SeedSequence([seed & 0xFFFFFFFF, 0x5E7])
        ).permutation(n_records)
        k = max(1, int(hotset_frac * n_records))
        hot, cold = order[:k].astype(np.int64), order[k:].astype(np.int64)
        w = 1.0 / np.arange(1.0, n_records + 1) ** zipf_s
        cdf = np.cumsum(w / w.sum())
        # shared across instances: arrays frozen, list views as tuples,
        # so no workload can mutate another's sampling state
        hot.setflags(write=False)
        cold.setflags(write=False)
        cdf.setflags(write=False)
        st = _STATE_CACHE[ck] = (hot, cold, tuple(hot.tolist()),
                                 tuple(cold.tolist()), cdf,
                                 tuple(cdf.tolist()))
    return st


@dataclass
class Op:
    kind: str      # 'read' | 'update' | 'insert'
    key: str
    dtype: str     # 'local' | 'global'
    value_bytes: int = RECORD_BYTES
    # pre-drawn leader-forward coin (Algorithm 1 line 6). None => the
    # simulator draws it live from its own RNG; batched schedules pre-draw
    # it per thread so the generator and vectorized engines see the same
    # stream regardless of event interleaving.
    fwd: Optional[bool] = None


class YCSBWorkload:
    def __init__(
        self,
        n_records: int = 10_000,
        read_prop: float = 0.5,
        update_prop: float = 0.5,
        distribution: str = "uniform",
        p_global: float = 0.5,
        hotset_frac: float = 0.2,
        hot_op_frac: float = 0.8,
        zipf_s: float = 0.99,
        seed: int = 0,
    ):
        if abs(read_prop + update_prop - 1.0) > 1e-9:
            raise ValueError("workload A proportions must sum to 1")
        if distribution not in ("uniform", "zipfian", "latest"):
            raise ValueError(distribution)
        self.n = n_records
        self.read_prop = read_prop
        self.distribution = distribution
        self.p_global = p_global
        self.rng = random.Random(seed)
        self.keys = _key_strings(n_records)
        # hotset membership is seed-derived workload state shared by both
        # engines (vectorized permutation, memoized across instances);
        # the zipf CDF over recency ranks drives the 'latest' sampler
        (self._hotset_arr, self._coldset_arr, self.hotset, self.coldset,
         self._latest_cdf_arr, self._latest_cdf) = _derived_state(
            seed, n_records, hotset_frac, zipf_s)
        self.hot_op_frac = hot_op_frac

    # ------------------------------------------------------------ sampling
    def _draw_index(self) -> int:
        if self.distribution == "uniform":
            return self.rng.randrange(self.n)
        if self.distribution == "zipfian":
            if self.rng.random() < self.hot_op_frac:
                return self.hotset[self.rng.randrange(len(self.hotset))]
            return self.coldset[self.rng.randrange(len(self.coldset))]
        # latest: rank 0 = newest (highest index, insertion order)
        import bisect
        r = bisect.bisect_left(self._latest_cdf, self.rng.random())
        return self.n - 1 - min(r, self.n - 1)

    def load_ops(self) -> List[Op]:
        """Load phase: insert every record (both tiers are populated by the
        DB layer; dtype here marks the copy targeted first)."""
        return [Op("insert", k, "local") for k in self.keys]

    def next_op(self) -> Op:
        idx = self._draw_index()
        kind = "read" if self.rng.random() < self.read_prop else "update"
        dtype = "global" if self.rng.random() < self.p_global else "local"
        return Op(kind, self.keys[idx], dtype)

    def run_ops(self, count: int) -> List[Op]:
        return [self.next_op() for _ in range(count)]

    # --------------------------------------------------------- batched path
    def batch_ops(self, count: int, rng: np.random.Generator
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Draw ``count`` ops in bulk with a numpy RNG.

        Returns ``(key_idx, kind, dtype)`` arrays (``kind``/``dtype`` use
        the :data:`KIND_CODE`/:data:`DTYPE_CODE` integer codes). This is the
        schedule source for both simulator engines: the generator oracle
        replays the same arrays one :class:`Op` at a time, the vectorized
        engine consumes them as columns. The ``latest`` sampler is a single
        ``searchsorted`` over the precomputed zipf CDF instead of the
        per-op ``bisect`` loop of :meth:`next_op`.
        """
        if self.distribution == "uniform":
            idx = rng.integers(0, self.n, size=count)
        elif self.distribution == "zipfian":
            hot = rng.random(count) < self.hot_op_frac
            hotset, coldset = self._hotset_arr, self._coldset_arr
            hi = rng.integers(0, len(hotset), size=count)
            if len(coldset):
                ci = rng.integers(0, len(coldset), size=count)
                idx = np.where(hot, hotset[hi], coldset[ci])
            else:
                idx = hotset[hi]
        else:  # latest: rank 0 = newest (highest index, insertion order)
            r = np.searchsorted(self._latest_cdf_arr, rng.random(count),
                                side="left")
            idx = self.n - 1 - np.minimum(r, self.n - 1)
        kind = np.where(rng.random(count) < self.read_prop,
                        KIND_CODE["read"], KIND_CODE["update"]
                        ).astype(np.uint8)
        dtype = np.where(rng.random(count) < self.p_global,
                         DTYPE_CODE["global"], DTYPE_CODE["local"]
                         ).astype(np.uint8)
        return idx.astype(np.int64), kind, dtype

"""Structure-of-arrays operation-record buffer.

``SimEdgeKV.records`` used to be a ``List[OpRecord]``; at fig scale that is
millions of dataclass instances and every metric was an O(records) Python
loop (re-run once per group for throughput). :class:`RecordArray` keeps one
column per field instead — floats for timing, small integer codes for
kind/dtype/group — so ``mean_latency``/``throughput`` become vectorized
numpy reductions. Storage is segmented: the oracle's per-op ``append``
lands in Python-list tails, while the vectorized engine's bulk exit path
(:meth:`extend_columns`) keeps its numpy chunks as-is (zero copy); the
cached column view concatenates segments on demand.

Iteration (and ``[]``) still yields :class:`OpRecord` views so existing
tests/examples that loop over ``sim.records`` keep working.

With ``stages=True`` (``SimEdgeKV(trace=True)``) each record additionally
carries the eight absolute stage-end timestamps of the
:mod:`repro_torch.obs.trace` span model — the raw material for
:class:`repro_torch.obs.TraceSet`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.trace import BOUNDARY_FIELDS

from .ycsb import DTYPES, KINDS

_FIELDS = ("t_start", "latency", "kind", "dtype", "group", "hops")
_DTYPES = (np.float64, np.float64, np.uint8, np.uint8, np.int32, np.int32)


@dataclass
class OpRecord:
    t_start: float
    latency: float
    kind: str      # read | update | insert
    dtype: str     # local | global
    group: str
    remote_hops: int = 0


class RecordArray:
    """Append-friendly SoA buffer of completed-operation records."""

    def __init__(self, stages: bool = False) -> None:
        self.stages = stages
        self._fields: Tuple[str, ...] = _FIELDS + (
            BOUNDARY_FIELDS if stages else ())
        self._dtypes: Tuple[type, ...] = _DTYPES + (
            (np.float64,) * len(BOUNDARY_FIELDS) if stages else ())
        self._chunks: List[dict] = []      # completed numpy segments
        self._tail: Dict[str, list] = {f: [] for f in self._fields}
        self._len = 0
        self._group_ids: List[str] = []           # code -> gid
        self._group_code: Dict[str, int] = {}     # gid -> code
        self._arrays: Optional[dict] = None       # cached numpy columns
        self._stats: Optional[Dict[str, Tuple[int, float, float]]] = None
        # cached per-group tail latencies, keyed by the percentile tuple
        self._tails: Dict[Tuple[float, ...], Dict[str, Tuple[float, ...]]] = {}

    def _invalidate(self) -> None:
        """Drop every derived snapshot (column view, group stats, tails).

        The single invalidation point for BOTH mutation paths — a new
        mutator that forgets to call this would resurrect the
        stale-``group_stats``-after-``extend_columns`` class of bug.
        """
        self._arrays = self._stats = None
        self._tails = {}

    # ------------------------------------------------------------ groups
    def register_group(self, gid: str) -> int:
        """Assign ``gid`` a stable integer code (idempotent).

        Codes are handed out at group-spawn time so they are identical
        across engines regardless of record order.
        """
        code = self._group_code.get(gid)
        if code is None:
            code = self._group_code[gid] = len(self._group_ids)
            self._group_ids.append(gid)
        return code

    def group_code(self, gid: str) -> int:
        return self._group_code[gid]

    # ------------------------------------------------------------ append
    def append(self, t_start: float, latency: float, kind: int, dtype: int,
               group: int, hops: int,
               bounds: Optional[Sequence[float]] = None) -> None:
        t = self._tail
        t["t_start"].append(t_start)
        t["latency"].append(latency)
        t["kind"].append(kind)
        t["dtype"].append(dtype)
        t["group"].append(group)
        t["hops"].append(hops)
        if self.stages:
            if bounds is None:
                raise ValueError("stage-enabled RecordArray needs bounds")
            for f, b in zip(BOUNDARY_FIELDS, bounds):
                t[f].append(b)
        self._len += 1
        self._invalidate()

    def _flush_tail(self) -> None:
        if self._tail["latency"]:
            self._chunks.append({
                f: np.asarray(self._tail[f], dtype=dt)
                for f, dt in zip(self._fields, self._dtypes)})
            self._tail = {f: [] for f in self._fields}

    def extend_columns(self, t_start: np.ndarray, latency: np.ndarray,
                       kind: np.ndarray, dtype: np.ndarray,
                       group: np.ndarray, hops: np.ndarray,
                       bounds: Optional[Sequence[np.ndarray]] = None) -> None:
        """Bulk-load a completed batch (the vectorized engine's exit path).

        The arrays are adopted as a segment without conversion — callers
        must not mutate them afterwards.
        """
        self._flush_tail()
        seg = dict(zip(_FIELDS, (t_start, latency, kind, dtype, group,
                                 hops)))
        if self.stages:
            if bounds is None:
                raise ValueError("stage-enabled RecordArray needs bounds")
            seg.update(zip(BOUNDARY_FIELDS, bounds))
        self._chunks.append(seg)
        self._len += len(latency)
        self._invalidate()

    # ------------------------------------------------------------ columns
    def columns(self) -> dict:
        if self._arrays is None:
            self._flush_tail()
            if len(self._chunks) == 1:
                self._arrays = self._chunks[0]
            else:
                segs = self._chunks or [{
                    f: np.empty(0, dt)
                    for f, dt in zip(self._fields, self._dtypes)}]
                self._arrays = {
                    f: np.concatenate([s[f] for s in segs])
                    for f in self._fields}
                self._chunks = [self._arrays]
        return self._arrays

    @property
    def t_start(self) -> np.ndarray:
        return self.columns()["t_start"]

    @property
    def latency(self) -> np.ndarray:
        return self.columns()["latency"]

    # ------------------------------------------------------------ metrics
    def mean_latency(self, kind: Optional[str] = None,
                     dtype: Optional[str] = None) -> float:
        cols = self.columns()
        sel = np.ones(len(self), dtype=bool)
        if kind is not None:
            sel &= cols["kind"] == KINDS.index(kind)
        if dtype is not None:
            sel &= cols["dtype"] == DTYPES.index(dtype)
        n = int(sel.sum())
        return float(cols["latency"][sel].sum() / n) if n else float("nan")

    def tail_latency(self, q: float, kind: Optional[str] = None,
                     dtype: Optional[str] = None) -> float:
        """``q``-th percentile latency (e.g. 95, 99) over the selected
        records — one ``np.percentile`` on the cached column view."""
        cols = self.columns()
        sel = np.ones(len(self), dtype=bool)
        if kind is not None:
            sel &= cols["kind"] == KINDS.index(kind)
        if dtype is not None:
            sel &= cols["dtype"] == DTYPES.index(dtype)
        lat = cols["latency"][sel]
        return float(np.percentile(lat, q)) if len(lat) else float("nan")

    def group_tails(self, percentiles: Tuple[float, ...] = (95.0, 99.0)
                    ) -> Dict[str, Tuple[float, ...]]:
        """Per-group tail latencies in ONE sort-partitioned pass over the
        buffer (cached until the next append): ``{gid: (p_q0, p_q1, ...)}``
        for the requested percentiles."""
        key = tuple(float(q) for q in percentiles)
        tails = self._tails.get(key)
        if tails is None:
            cols = self.columns()
            g = cols["group"]
            order = np.argsort(g, kind="stable")
            gs = g[order]
            lat = cols["latency"][order]
            bounds = np.searchsorted(gs, np.arange(len(self._group_ids) + 1))
            tails = self._tails[key] = {
                self._group_ids[c]: tuple(
                    float(v) for v in np.percentile(
                        lat[bounds[c]:bounds[c + 1]], key))
                for c in range(len(self._group_ids))
                if bounds[c + 1] > bounds[c]
            }
        return tails

    def group_stats(self, percentiles: Optional[Tuple[float, ...]] = None
                    ) -> Dict[str, tuple]:
        """Per-group ``(count, first_start, last_end)`` in ONE vectorized
        pass over the buffer (cached until the next append).  With
        ``percentiles`` given, each tuple is extended with the group's
        tail latencies, e.g. ``percentiles=(95, 99)`` yields
        ``(count, first_start, last_end, p95, p99)``."""
        if self._stats is None:
            cols = self.columns()
            g = cols["group"]
            ngroups = len(self._group_ids)
            counts = np.bincount(g, minlength=ngroups)
            first = np.full(ngroups, np.inf)
            last = np.full(ngroups, -np.inf)
            np.minimum.at(first, g, cols["t_start"])
            np.maximum.at(last, g, cols["t_start"] + cols["latency"])
            self._stats = {
                self._group_ids[c]: (int(counts[c]), float(first[c]),
                                     float(last[c]))
                for c in range(ngroups) if counts[c]
            }
        if percentiles is None:
            return self._stats
        tails = self.group_tails(tuple(percentiles))
        return {gid: stat + tails[gid]
                for gid, stat in self._stats.items()}

    # ----------------------------------------------------- list-compat API
    def __len__(self) -> int:
        return self._len

    def _view(self, i: int) -> OpRecord:
        cols = self.columns()
        return OpRecord(float(cols["t_start"][i]), float(cols["latency"][i]),
                        KINDS[cols["kind"][i]], DTYPES[cols["dtype"][i]],
                        self._group_ids[cols["group"][i]],
                        int(cols["hops"][i]))

    def __getitem__(self, i: int) -> OpRecord:
        if isinstance(i, slice):
            return [self._view(j) for j in range(*i.indices(len(self)))]
        return self._view(i if i >= 0 else len(self) + i)

    def __iter__(self) -> Iterator[OpRecord]:
        return (self._view(i) for i in range(len(self)))

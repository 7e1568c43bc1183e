"""Virtual-time span model for per-op distributed traces.

Every completed client operation decomposes into eight causally ordered
stages, matching the §7 measurement path end to end::

    request    client -> edge node [-> forward | -> gateway admit]
    route      Chord overlay hops to the owner gateway (0 on a cache hit)
    lease      async-handoff detour: redirect hop + pull-on-demand transfer
    ingress    owner gateway -> group leader (global ops only)
    queue      wait for the leader (Raft serializes one commit at a time)
    service    commit/read execution incl. the page-cache seek penalty
    replicate  quorum round (writes) / ReadIndex heartbeat round (reads)
    response   acks back: leader -> gateway -> home -> client (or error acks)

Stages are stored as **absolute stage-end timestamps** (simulated seconds),
not durations: the simulators accumulate virtual time as a chain of rounded
float additions, so only absolute boundaries reproduce bitwise across
engines and telescope exactly — ``b_end - t_start`` *is* the recorded
end-to-end latency, bit for bit.  A stage an op never enters repeats the
previous boundary (zero duration); a refused op jumps straight from the
refusal point to ``response``.

:class:`TraceSet` is the analysis container: column-oriented (numpy),
JSON round-trippable (the ``python -m repro_torch.obs`` CLI input format), with
per-stage summaries, critical-path extraction, and a text flamegraph.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: Chronological stage names; stage ``i`` spans ``bounds[i-1] .. bounds[i]``
#: (with ``t_start`` as the implicit bound before ``request``).
STAGES: Tuple[str, ...] = ("request", "route", "lease", "ingress",
                           "queue", "service", "replicate", "response")

#: Column names for the absolute stage-end timestamps, in stage order.
BOUNDARY_FIELDS: Tuple[str, ...] = tuple(
    "b_" + s for s in STAGES[:-1]) + ("b_end",)

# indices for instrumentation sites (cluster.py / vectorized.py)
B_REQUEST, B_ROUTE, B_LEASE, B_INGRESS = 0, 1, 2, 3
B_QUEUE, B_SERVICE, B_REPLICATE, B_END = 4, 5, 6, 7

_BASE = ("t_start", "latency", "kind", "dtype", "group", "hops")


def fill_bounds(t0: float, tb: List[float]) -> List[float]:
    """Fill-forward NaN slots in a boundary list, in place.

    Instrumentation samples only the stages an op actually enters
    (refusals return early, local ops skip route/lease/ingress); a
    skipped stage inherits the previous boundary — zero duration.
    """
    prev = t0
    for i, v in enumerate(tb):
        if v != v:                  # NaN: stage never sampled
            tb[i] = prev
        else:
            prev = v
    return tb


class TraceSet:
    """Column-oriented set of per-op spans (one row per completed op)."""

    def __init__(self, columns: Dict[str, np.ndarray],
                 group_ids: Sequence[str],
                 kinds: Sequence[str], dtypes: Sequence[str],
                 meta: Optional[dict] = None,
                 metrics: Optional[dict] = None) -> None:
        missing = [f for f in _BASE + BOUNDARY_FIELDS if f not in columns]
        if missing:
            raise ValueError(f"trace columns missing {missing}")
        self.columns = columns
        self.group_ids = list(group_ids)
        self.kinds = list(kinds)
        self.dtypes = list(dtypes)
        self.meta = dict(meta or {})
        self.metrics = dict(metrics or {})

    # ------------------------------------------------------------ build
    @classmethod
    def from_records(cls, records, meta: Optional[dict] = None,
                     metrics: Optional[dict] = None) -> "TraceSet":
        """Build from a stage-enabled :class:`repro_torch.sim.records.RecordArray`."""
        from repro_torch.sim.ycsb import DTYPES, KINDS
        cols = records.columns()
        if BOUNDARY_FIELDS[0] not in cols:
            raise ValueError(
                "records carry no stage columns — run the simulator with "
                "trace=True to record spans")
        return cls({f: np.asarray(cols[f]) for f in _BASE + BOUNDARY_FIELDS},
                   records._group_ids, KINDS, DTYPES, meta=meta,
                   metrics=metrics)

    def __len__(self) -> int:
        return len(self.columns["latency"])

    # ------------------------------------------------------------ spans
    def bounds(self) -> np.ndarray:
        """(n_ops, 9) absolute boundaries: t_start then the 8 stage ends."""
        c = self.columns
        return np.stack([c["t_start"]] + [c[f] for f in BOUNDARY_FIELDS],
                        axis=1)

    def stage_durations(self) -> np.ndarray:
        """(n_ops, 8) per-stage durations (diffs of absolute boundaries)."""
        return np.diff(self.bounds(), axis=1)

    def select(self, dtype: Optional[str] = None,
               kind: Optional[str] = None) -> np.ndarray:
        c = self.columns
        sel = np.ones(len(self), dtype=bool)
        if dtype is not None:
            sel &= c["dtype"] == self.dtypes.index(dtype)
        if kind is not None:
            sel &= c["kind"] == self.kinds.index(kind)
        return sel

    # ---------------------------------------------------------- analysis
    def stage_summary(self, dtype: Optional[str] = None,
                      kind: Optional[str] = None) -> Dict[str, dict]:
        """Per-stage ``{mean, p95, max, share}`` over the selected ops."""
        sel = self.select(dtype, kind)
        if not sel.any():
            return {}
        d = self.stage_durations()[sel]
        total = float(self.columns["latency"][sel].sum())
        out: Dict[str, dict] = {}
        for i, stage in enumerate(STAGES):
            col = d[:, i]
            out[stage] = {
                "mean": float(col.mean()),
                "p95": float(np.percentile(col, 95.0)),
                "max": float(col.max()),
                "share": float(col.sum() / total) if total else 0.0,
            }
        return out

    def critical_path(self, dtype: Optional[str] = None) -> List[dict]:
        """Stages ranked by mean contribution, with how often each stage
        *dominates* an op (is that op's single largest span)."""
        sel = self.select(dtype)
        if not sel.any():
            return []
        d = self.stage_durations()[sel]
        dom = np.bincount(np.argmax(d, axis=1), minlength=len(STAGES))
        order = np.argsort(-d.mean(axis=0), kind="stable")
        return [{
            "stage": STAGES[i],
            "mean": float(d[:, i].mean()),
            "dominates": float(dom[i] / d.shape[0]),
        } for i in order]

    # --------------------------------------------------------- rendering
    def flamegraph(self, width: int = 60, split: str = "dtype") -> str:
        """Text flamegraph: one frame per stage, bar width ~ mean share.

        ``split="dtype"`` renders a sub-graph per tier (the §7
        local-vs-global latency split); ``split="none"`` one graph.
        """
        groups: List[Tuple[str, Optional[str]]] = [("all ops", None)]
        if split == "dtype":
            groups += [(f"{d} ops", d) for d in self.dtypes
                       if self.select(dtype=d).any()]
        lines: List[str] = []
        for title, dtype in groups:
            sel = self.select(dtype=dtype)
            if not sel.any():
                continue
            lat = self.columns["latency"][sel]
            d = self.stage_durations()[sel]
            mean_tot = float(lat.mean())
            lines.append(f"{title}  n={int(sel.sum())}  "
                         f"mean={mean_tot * 1e3:.3f}ms  "
                         f"p95={np.percentile(lat, 95) * 1e3:.3f}ms")
            scale = width / mean_tot if mean_tot else 0.0
            for i, stage in enumerate(STAGES):
                m = float(d[:, i].mean())
                bar = "#" * max(0, round(m * scale))
                if m and not bar:
                    bar = "."         # nonzero but below one cell
                share = m / mean_tot if mean_tot else 0.0
                lines.append(f"  {stage:<9} {m * 1e3:9.4f}ms {share:6.1%} "
                             f"|{bar}")
            lines.append("")
        return "\n".join(lines).rstrip() + "\n"

    # ---------------------------------------------------------- file I/O
    def to_json(self, path: Optional[str] = None) -> str:
        doc = {
            "format": "repro.obs.trace/v1",
            "stages": list(STAGES),
            "meta": self.meta,
            "group_ids": self.group_ids,
            "kinds": self.kinds,
            "dtypes": self.dtypes,
            "metrics": self.metrics,
            "columns": {f: np.asarray(self.columns[f]).tolist()
                        for f in _BASE + BOUNDARY_FIELDS},
        }
        text = json.dumps(doc, indent=1, sort_keys=True)
        if path is not None:
            with open(path, "w") as fh:
                fh.write(text + "\n")
        return text

    @classmethod
    def from_json(cls, path: str) -> "TraceSet":
        with open(path) as fh:
            doc = json.load(fh)
        if doc.get("format") != "repro.obs.trace/v1":
            raise ValueError(f"{path}: not a repro.obs trace file")
        int_fields = {"kind", "dtype", "group", "hops"}
        cols = {f: np.asarray(v, dtype=(np.int64 if f in int_fields
                                        else np.float64))
                for f, v in doc["columns"].items()}
        return cls(cols, doc["group_ids"], doc["kinds"], doc["dtypes"],
                   meta=doc.get("meta"), metrics=doc.get("metrics"))

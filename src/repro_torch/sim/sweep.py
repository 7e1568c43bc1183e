"""Batched parameter sweeps: N EdgeKV simulations as ONE PyTorch array
program on the GPU — open loop (exogenous Poisson arrivals) and closed
loop (think-time feedback, the regime every paper figure actually uses).

EdgeKV's evaluation (§6) is a grid of scenarios — workload mix x
local/global ratio x load x topology — and with the fast engine each grid
point still costs a separate numpy pass.  This module runs the whole grid
instead: :func:`run_sweep` takes a list of :class:`SweepPoint`
configurations and evaluates them in one batched device program.

Closed loop (``run_sweep(..., loop="closed")``): a worker thread's next
arrival is its previous completion (zero think time), so arrival times
are no longer exogenous — they are the *fixed point* of the coupled
recurrence in which threads interact only through each serving leader's
FIFO commit stage (the max-plus scan) and its LRU page cache.  The
program iterates a batched round to that fixed point in a host loop that
stops at the first round that changes nothing: completions -> next
arrivals (elementwise :func:`~repro_torch.sim.vectorized.arrival_chain`)
-> per-row stable sort into leader-arrival order (ties broken by flat
position = the heap engine's pid order) -> seen-before page penalties ->
batched max-plus departure scan -> completions
(:func:`~repro_torch.sim.vectorized.completion_chain`).  Unresolved ops
(predecessor not yet computed) carry ``+inf`` arrivals, which sorts them
harmlessly after every resolved op, so each round extends the resolved
wavefront by at least one op per thread and the iteration converges —
bitwise — in O(ops-per-thread) rounds.  The true schedule is a fixed
point of the round map, so extra rounds are no-ops.

Layout: the grid is flattened to **one row per (config, serving group)**
— the granularity at which the leader FIFO serializes — with ops in
leader-arrival order and ragged tails padded.  That row axis is both the
broadcast axis for the pure delay-column chains shared with the per-run
engine (:func:`repro_torch.sim.vectorized.arrival_chain` /
:func:`~repro_torch.sim.vectorized.completion_chain`, evaluated from
stacked per-config component tables) and the batch axis of the max-plus
departure scan from :mod:`repro_torch.kernels.maxplus_scan` (the
``maxplus_chunked`` warp-scan kernel for the open loop, the exact
``maxplus_seq`` kernel for the closed loop), so the open-loop program
needs no in-program gather/scatter at all (the closed-loop rounds
gather/scatter because the order itself is part of the fixed point).
Per-row masked category reductions come back as batched aggregates;
:class:`SweepResult` folds them on the host into per-point columns —
mean latencies by kind/dtype, paper-metric throughput, p95/p99 tails —
the :class:`~repro_torch.sim.records.RecordArray` aggregate shape lifted
to a whole grid.

Only the parts that are inherently host-side stay in numpy: drawing the
op schedules (the numpy RNG streams must match the fast engine draw for
draw), Chord routing (one shared ring per group count, one ``route`` per
(gateway, successor-vnode) class for the *whole grid*), the exact LRU
page-penalty masks (:func:`~repro_torch.sim.vectorized.lru_hit_mask`),
and the per-point folds (float sums in a fixed order, so repeat runs are
bit-identical).

Exactness: every per-point result matches an independent
``SimEdgeKV(engine="fast")`` run on the same seeds to ~1e-13 relative —
the program evaluates the identical float64 expressions; only the
scan/reduction association order differs (and in the closed loop not
even that: its default scan is the exact sequential one).  Every device
tensor is float64, int32, int64 or bool, named explicitly: torch's
float32 default never enters.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from itertools import product
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.hashring import ChordRing, stable_hash
from repro_torch.device import resolve_device
from repro_torch.kernels.maxplus_scan import maxplus_depart
from repro_torch.obs import walltime
from repro_torch.obs.trace import STAGES as OBS_STAGES

from .cluster import ServiceParams, arrival_seed, closed_loop_plan
from .network import SETTINGS
from .vectorized import (GLOBAL_CODE, READ_CODE, _DelayModel,
                         _open_loop_segments, arrival_chain,
                         completion_chain, lru_hit_mask, plan_columns)

_PAIRS = ("c_req", "c_resp", "f_req", "f_resp", "sg_req", "sg_resp",
          "h_req", "g_resp", "svc_base")


@dataclass(frozen=True)
class SweepPoint:
    """One configuration in a sweep grid.

    ``rate`` drives open-loop points; ``threads`` / ``ops`` (worker
    threads per client group, total ops per client group — the
    ``run_closed_loop`` knobs) drive closed-loop points.  The unused
    axis is simply ignored by the other loop mode.
    """
    p_global: float = 0.5
    rate: float = 200.0
    groups: int = 3
    n_records: int = 10_000
    distribution: str = "uniform"
    group_size: int = 3
    threads: int = 100
    ops: int = 10_000


def sweep_grid(p_globals: Sequence[float] = (0.0, 0.25, 0.5, 0.75),
               rates: Sequence[float] = (200.0, 400.0, 600.0, 800.0),
               contention: Sequence[int] = (10_000, 2_500),
               groups: Sequence[int] = (3, 5),
               distribution: str = "uniform",
               group_size: int = 3) -> List[SweepPoint]:
    """The §6-style evaluation grid: local/global ratio x contention
    (keyspace size — fewer records, hotter pages) x arrival rate (the
    Fig 13 axis) x group count.  Defaults to 4 x 2 x 4 x 2 = 64 points.
    """
    return [SweepPoint(p_global=pg, rate=float(r), n_records=int(nr),
                       groups=int(g), distribution=distribution,
                       group_size=group_size)
            for pg, nr, r, g in product(p_globals, contention, rates,
                                        groups)]


def closed_grid(p_globals: Sequence[float] = (0.0, 0.25, 0.5, 1.0),
                contention: Sequence[int] = (10_000, 2_500),
                groups: Sequence[int] = (3, 5),
                distribution: str = "uniform", group_size: int = 3,
                threads: int = 32, ops: int = 320) -> List[SweepPoint]:
    """A §6-style *closed-loop* grid: local/global ratio x contention x
    group count, each point a ``run_closed_loop`` configuration
    (``threads`` workers per client group sharing ``ops`` operations).
    Defaults to 4 x 2 x 2 = 16 points."""
    return [SweepPoint(p_global=pg, n_records=int(nr), groups=int(g),
                       distribution=distribution, group_size=group_size,
                       threads=int(threads), ops=int(ops))
            for pg, nr, g in product(p_globals, contention, groups)]


@dataclass
class SweepResult:
    """Batched sweep aggregates — one SoA column per metric, one slot per
    grid point (the :class:`~repro_torch.sim.records.RecordArray` aggregate
    shape, lifted to a whole grid).

    ``info`` says where the run went: ``device``, ``host_s`` (all host
    time: planning, folds, and the rounds of a host-path grid),
    ``plan_s`` (the part of it before the program or rounds start),
    ``device_s`` (the device program, synchronized),
    ``grid`` (the (rows, slots) shape of its departure scan) and, for
    the closed loop, ``rounds`` (the fixed-point rounds run, the
    converging round included) and ``blocks`` (the point blocks, one a
    device).  With several blocks, ``rounds`` is the largest count of
    any block, ``device_s`` covers every block, synchronized, and
    ``grid`` is the common (padded) shape.  A closed grid in the
    eviction regime runs on the host: its ``grid``, ``rounds`` and
    ``blocks`` are None."""
    points: List[SweepPoint]
    columns: Dict[str, np.ndarray]
    walltime_s: float = 0.0
    info: Dict[str, object] = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.points)

    def row(self, i: int) -> dict:
        r = dict(asdict(self.points[i]))
        r.update({k: float(v[i]) for k, v in self.columns.items()})
        return r

    def rows(self) -> List[dict]:
        return [self.row(i) for i in range(len(self))]


_KEYSPACE_HASHES: Dict[int, np.ndarray] = {}


def _keyspace_hashes(keys: List[str]) -> np.ndarray:
    """Ring hashes for a whole YCSB keyspace, memoized by size (the key
    strings are deterministic) — one sha1 pass per keyspace for the whole
    grid instead of one per point."""
    kh = _KEYSPACE_HASHES.get(len(keys))
    if kh is None:
        kh = _KEYSPACE_HASHES[len(keys)] = np.fromiter(
            (stable_hash(k) for k in keys), dtype=np.uint64,
            count=len(keys))
    return kh


class _Topology:
    """Shared Chord topology for every sweep point with the same group
    count: the ring depends only on the gateway names, so construction,
    key -> successor-vnode maps, and route classes amortize across the
    grid (one ``ring.route`` per (gateway, successor-vnode) class for the
    whole sweep)."""

    def __init__(self, groups: int, virtual_nodes: int = 1):
        self.ring = ChordRing(virtual_nodes=virtual_nodes)
        self.gw_of_code = [f"gw{i}" for i in range(groups)]
        for gw in self.gw_of_code:
            self.ring.add_node(gw)
        self._vh = np.asarray(self.ring._vhashes, dtype=np.uint64)
        self._svn: Dict[int, np.ndarray] = {}    # keyspace -> vnode of key
        self._cls: Dict[int, Tuple[int, int]] = {}  # class -> (owner, hops)

    def routes(self, client_codes: np.ndarray, key_indices: np.ndarray,
               keys: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        svn_of_key = self._svn.get(len(keys))
        if svn_of_key is None:
            svn_of_key = self._svn[len(keys)] = (
                np.searchsorted(self._vh, _keyspace_hashes(keys),
                                side="left") % len(self._vh)
            ).astype(np.int64)
        svn = svn_of_key[key_indices]
        packed = client_codes.astype(np.int64) * len(self._vh) + svn
        uniq, uidx, inv = np.unique(packed, return_index=True,
                                    return_inverse=True)
        owner_u = np.empty(len(uniq), np.int32)
        hops_u = np.empty(len(uniq), np.int32)
        for j, u in enumerate(uniq.tolist()):
            ent = self._cls.get(u)
            if ent is None:
                rep = int(uidx[j])
                path = self.ring.route(
                    self.gw_of_code[int(client_codes[rep])],
                    keys[int(key_indices[rep])])
                ent = self._cls[u] = (
                    int(path[-1][2:]), len(path) - 1)  # "gw<i>" -> code
            owner_u[j], hops_u[j] = ent
        return owner_u[inv], hops_u[inv]


# one shared topology per (group count, vnodes) for the whole *process*:
# the ring is a pure function of the gateway names, so the open- and
# closed-loop sweep paths (and repeated run_sweep calls) reuse the same
# key->vnode maps and route-class memos instead of re-deriving them
_TOPOLOGIES: Dict[Tuple[int, int], _Topology] = {}


def _topology(groups: int, virtual_nodes: int) -> _Topology:
    topo = _TOPOLOGIES.get((groups, virtual_nodes))
    if topo is None:
        topo = _TOPOLOGIES[(groups, virtual_nodes)] = _Topology(
            groups, virtual_nodes)
    return topo


def to_device(cols: Dict[str, np.ndarray],
              device) -> Dict[str, torch.Tensor]:
    """Host numpy columns as tensors on ``device``, each keeping its
    dtype (float64, int32, int64, bool)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in cols.items()}


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _open_program(tblr: Dict[str, torch.Tensor],
                  flat: Dict[str, torch.Tensor], gidx: torch.Tensor, *,
                  max_hops: int, scan_backend: str):
    """The open-loop grid program on one device.

    Everything is row-space (R, Ls): one row per (config, serving group),
    ops in leader-arrival order, padded tails masked by ``valid``.  The
    per-row delay chains broadcast each row's (R, 2) component table
    against its (R, Ls) op columns.
    """
    n_pad = flat["t0"].shape[0]
    # row-space views: one gather per op column (padding index points at
    # the zeroed pad slot appended to each flat column).  torch has no
    # take(mode="clip"), so the indices are clamped instead
    g = gidx.long().clamp(0, n_pad - 1)

    def take(name):
        return flat[name][g]
    t0, is_w, glob = take("t0"), take("is_w"), take("glob")
    lf, remote = take("lf"), take("remote")
    valid = gidx < n_pad - 1

    def pick(name):
        col = tblr[name]
        return torch.where(is_w, col[:, 1:2], col[:, 0:1])
    cuts: list = []
    arr = arrival_chain(torch, t0, pick("c_req"), pick("f_req"),
                        pick("sg_req"), pick("h_req"), lf, glob,
                        take("hops"), max_hops, cuts=cuts)
    b_req, b_route = cuts[0], cuts[1]
    svc = pick("svc_base") + take("pens")

    # the leader FIFO stage: batched max-plus departure scan, one
    # independent recurrence per row (padding tails carry harmlessly)
    dep = maxplus_depart(arr, svc, backend=scan_backend)

    ccuts: list = []
    comp = completion_chain(torch, dep, pick("q_ri"), pick("sg_resp"),
                            pick("g_resp"), pick("f_resp"), pick("c_resp"),
                            lf, glob, remote, cuts=ccuts)
    b_repl = ccuts[0]
    lat = comp - t0

    # span-model boundaries (rows are already leader-arrival order):
    # service start = max(arrival, previous departure), clamped to the
    # departure because the closed-form scans reassociate float adds and
    # may sit an ulp off the sequential recurrence
    prev = torch.cat([torch.full((dep.shape[0], 1), -torch.inf,
                                 dtype=dep.dtype, device=dep.device),
                      dep[:, :-1]], dim=1)
    start = torch.minimum(torch.maximum(arr, prev), dep)
    zero = torch.zeros((), dtype=dep.dtype, device=dep.device)
    # per-row per-stage duration sums (open loop has no lease stage); the
    # host folds rows into per-point means alongside cnt4/sum4
    stage_sum = torch.stack([
        torch.where(valid, d, zero).sum(dim=1)
        for d in (b_req - t0, b_route - b_req,
                  torch.zeros_like(t0),          # lease
                  arr - b_route, start - arr, dep - start,
                  b_repl - dep, comp - b_repl)], dim=1)

    # per-row aggregates over (is_write x is_global) categories; the host
    # folds rows into per-point kind/dtype means
    cnt4, sum4 = [], []
    for m in (valid & ~is_w & ~glob, valid & ~is_w & glob,
              valid & is_w & ~glob, valid & is_w & glob):
        cnt4.append(m.sum(dim=1))
        sum4.append(torch.where(m, lat, zero).sum(dim=1))
    return torch.stack(cnt4, dim=1), torch.stack(sum4, dim=1), lat, \
        stage_sum


def run_sweep(points: Iterable[SweepPoint], *, duration: float = 2.0,
              setting: str = "edge", seed: int = 0,
              service: Optional[ServiceParams] = None,
              virtual_nodes: int = 1, scan_backend: Optional[str] = None,
              percentiles: Sequence[float] = (95.0, 99.0),
              loop: str = "open", devices: int = 1,
              max_rounds: Optional[int] = None,
              device=None) -> SweepResult:
    """Evaluate a sweep grid in one batched device program.

    ``loop="open"`` (default): each :class:`SweepPoint` reproduces
    exactly what ``SimEdgeKV(setting=setting,
    group_sizes=(group_size,)*groups, seed=seed,
    engine="fast").run_open_loop(rate, duration, workload_kw)`` would
    record — same schedules, routes, penalties, and float64 delay
    arithmetic — but the grid shares one program, one ring per group
    count, and one batched departure scan.

    ``loop="closed"``: each point reproduces
    ``run_closed_loop(threads_per_client=p.threads,
    ops_per_client=p.ops, workload_kw=..., seed_offset=seed)`` on the
    same fast-engine sim (closed-loop schedules are seeded by
    ``seed_offset``, so ``seed`` plays that role here; ``duration`` and
    ``p.rate`` are ignored).  The whole grid runs as one batched
    fixed-point iteration (see the module docstring).  ``max_rounds``
    caps the fixed-point iteration (default: generous in
    ops-per-thread); non-convergence raises instead of returning wrong
    numbers.  Grids whose (config, group) rows can evict page-cache
    entries (distinct keys at one leader exceeding
    ``service.page_cache_keys``) take an equivalent host-side fixed
    point with the exact LRU replay
    (:func:`~repro_torch.sim.vectorized.lru_hit_mask`), whatever
    ``devices`` says.

    ``devices`` (closed loop only) deals the points round-robin into
    ``D = min(devices, len(points))`` blocks, pads every block to the
    common shape and iterates each to its own fixed point, bit-identical
    to ``devices=1``.  The visible devices are ``device``'s kind: on
    CUDA, ``torch.cuda.device_count()`` GPUs, block ``d`` running on its
    own GPU, ``cuda:d`` (counted from ``device``'s index when it names
    one), and ``devices`` past the visible GPUs raises ``ValueError``; no
    two blocks share a GPU.  On ``device="cpu"`` any ``devices >= 1`` is
    taken and the blocks run in turn on the host, as the reference's
    tests reach several devices through XLA's forced host devices.

    ``device`` is where the program runs: ``None`` means the GPU, and
    raises when none is visible; ``"cpu"`` runs every kernel's plain
    PyTorch version.

    ``scan_backend`` selects the leader-stage scan.  ``None`` (default)
    resolves per loop mode: ``"cuda"`` (the ``maxplus_chunked``
    warp-scan kernel, closed form per tile) for open loop, ``"seq"`` (the
    ``maxplus_seq`` kernel, the engine's exact sequential float
    association) for closed loop; ``"assoc"`` is the torch
    ``cumsum``/``cummax`` closed form.  The closed loop defaults to
    ``"seq"`` because its fixed point feeds completions back into *queue
    ordering*: the closed-form scans reassociate float adds, and a 1-ulp
    deviation can flip the order of two near-tied arrivals and snowball
    into a genuinely different schedule — harmless ulps in the open
    loop, percent-level metric drift in the closed loop.
    ``"assoc"``/``"cuda"`` remain valid for closed loop where
    ulp-exactness is not required (self-consistent schedules, same
    fixed-point semantics).
    """
    points = [points] if isinstance(points, SweepPoint) else list(points)
    if not points:
        raise ValueError("empty sweep grid")
    if duration <= 0:
        raise ValueError("duration must be positive")
    if loop not in ("open", "closed"):
        raise ValueError(f"unknown loop mode {loop!r}")
    if devices < 1:
        raise ValueError("devices must be >= 1")
    if scan_backend is None:
        scan_backend = "seq" if loop == "closed" else "cuda"
    if scan_backend not in ("seq", "assoc", "cuda"):
        raise ValueError(f"unknown scan_backend {scan_backend!r}")
    if loop == "open" and scan_backend == "seq":
        raise ValueError("scan_backend='seq' is closed-loop only")
    dev = resolve_device(device, "run_sweep")
    if loop == "closed":
        return _run_closed(points, setting=setting, seed=seed,
                           service=service, virtual_nodes=virtual_nodes,
                           scan_backend=scan_backend,
                           percentiles=percentiles, devices=devices,
                           max_rounds=max_rounds, device=dev)
    if devices != 1:
        raise ValueError("devices > 1 requires loop='closed'")
    t_wall = walltime()
    svcp = service or ServiceParams()
    dm = _DelayModel(SETTINGS[setting], svcp)
    capacity = max(1, svcp.page_cache_keys)
    qs = tuple(float(q) for q in percentiles)

    # ---- host side: schedules, routes, penalties (seed-exact numpy) ----
    cols_op: Dict[str, List[np.ndarray]] = {
        k: [] for k in ("t0", "pens", "is_w", "glob", "lf", "remote",
                        "hops", "client")}
    per: List[dict] = []       # per-point metadata
    row_idx: List[np.ndarray] = []   # per row: global op indices
    row_tbl: List[int] = []          # per row: owning point
    offset = 0
    for pi, p in enumerate(points):
        topo = _topology(p.groups, virtual_nodes)
        clients = [(c, c, p.group_size, arrival_seed(seed, f"g{c}"))
                   for c in range(p.groups)]
        segs = _open_loop_segments(
            clients, p.rate, duration, 0.0,
            dict(p_global=p.p_global, distribution=p.distribution,
                 n_records=p.n_records))
        keys = segs[0][1].keys
        client = np.concatenate([np.full(len(s[2]), s[0], np.int32)
                                 for s in segs])
        t0 = np.concatenate([s[2] for s in segs])
        key_idx = np.concatenate([s[3] for s in segs])
        kind = np.concatenate([s[4] for s in segs])
        dtype = np.concatenate([s[5] for s in segs])
        fwd = np.concatenate([s[6] for s in segs])
        is_w = kind != READ_CODE
        glob = dtype == GLOBAL_CODE
        serving = client.copy()
        hops = np.zeros(len(t0), np.int32)
        if glob.any():
            owner, h = topo.routes(client[glob], key_idx[glob], keys)
            serving[glob] = owner
            hops[glob] = h

        def bw(pair):
            return np.where(is_w, pair[1], pair[0])
        lf = (~glob) & fwd
        # host copy of the arrival chain, only to fix the per-group scan
        # order and LRU replay order (the program re-derives the values)
        arr = arrival_chain(np, t0, bw(dm.c_req), bw(dm.f_req),
                            bw(dm.sg_req), bw(dm.h_req), lf, glob, hops,
                            int(hops.max()) if len(hops) else 0)
        pens = np.zeros(len(t0))
        # one lexsort per point: (serving, arrival, index) makes every
        # serving group a contiguous, arrival-ordered slice — the same
        # per-group order the fast engine scans in
        order_all = np.lexsort((np.arange(len(t0)), arr, serving))
        sv = serving[order_all]
        cuts = np.flatnonzero(sv[1:] != sv[:-1]) + 1
        for order in np.split(order_all, cuts):
            hit = lru_hit_mask(key_idx[order], capacity)
            pens[order] = np.where(hit, 0.0, dm.seek)
            row_idx.append(offset + order)
            row_tbl.append(pi)
        for name, col in (("t0", t0), ("pens", pens), ("is_w", is_w),
                          ("glob", glob), ("lf", lf),
                          ("remote", glob & (serving != client)),
                          ("hops", hops), ("client", client)):
            cols_op[name].append(col)
        per.append(dict(n=len(t0), offset=offset,
                        seg_len=[len(s[2]) for s in segs],
                        q_ri=(dm.readindex(p.group_size),
                              dm.quorum(p.group_size))))
        offset += len(t0)

    n_total = offset
    # one extra zeroed slot per column backs the row padding
    flat = {k: np.concatenate(v + [np.zeros(1, v[0].dtype)])
            for k, v in cols_op.items()}

    # ---- row-space index: (R, Ls) with padded ragged tails ----
    R = len(row_idx)
    Ls = max(len(r) for r in row_idx)
    gidx = np.full((R, Ls), n_total, np.int32)
    for r, idx in enumerate(row_idx):
        gidx[r, :len(idx)] = idx
    valid = gidx < n_total
    tbl_pt = {name: np.tile(np.asarray(getattr(dm, name), np.float64),
                            (len(points), 1))
              for name in _PAIRS}
    tbl_pt["q_ri"] = np.asarray([d["q_ri"] for d in per], np.float64)
    row_tbl_arr = np.asarray(row_tbl)
    tblr = {name: v[row_tbl_arr] for name, v in tbl_pt.items()}
    max_hops = int(flat["hops"].max()) if n_total else 0

    # ---- the device program ----
    t_dev = walltime()
    cnt4, sum4, lat_rows, stage_sum = (_host(t) for t in _open_program(
        to_device(tblr, dev),
        to_device({k: v for k, v in flat.items() if k != "client"}, dev),
        torch.from_numpy(gidx).to(dev), max_hops=max_hops,
        scan_backend=scan_backend))
    plan_s, device_s = t_dev - t_wall, walltime() - t_dev

    # ---- fold rows back into per-point RecordArray-style aggregates ----
    lat_op = np.empty(n_total)
    lat_op[gidx[valid]] = np.asarray(lat_rows)[valid]
    cnt4 = np.asarray(cnt4, np.float64)
    sum4 = np.asarray(sum4)
    N = len(points)
    cnt_pt = np.zeros((N, 4))
    sum_pt = np.zeros((N, 4))
    for c in range(4):
        cnt_pt[:, c] = np.bincount(row_tbl_arr, cnt4[:, c], minlength=N)
        sum_pt[:, c] = np.bincount(row_tbl_arr, sum4[:, c], minlength=N)

    # categories: (read-local, read-global, update-local, update-global)
    sel = {"mean_latency": (0, 1, 2, 3), "read_latency": (0, 1),
           "update_latency": (2, 3), "local_latency": (0, 2),
           "global_latency": (1, 3), "update_global_latency": (3,)}
    cols: Dict[str, np.ndarray] = {
        "ops": np.asarray([d["n"] for d in per], np.int64)}
    for name, cats in sel.items():
        c = cnt_pt[:, list(cats)].sum(axis=1)
        s = sum_pt[:, list(cats)].sum(axis=1)
        cols[name] = np.where(c > 0, s / np.maximum(c, 1), np.nan)

    # per-point per-stage mean durations (span model, program aggregates)
    n_ops_pt = cnt_pt.sum(axis=1)
    stage_sum = np.asarray(stage_sum, np.float64)
    for si, stage in enumerate(OBS_STAGES):
        s = np.bincount(row_tbl_arr, stage_sum[:, si], minlength=N)
        cols[f"stage_{stage}"] = np.where(
            n_ops_pt > 0, s / np.maximum(n_ops_pt, 1), np.nan)

    # paper-metric throughput (average of per-client rates) and tails,
    # from the op-order latency column — same expressions as
    # RecordArray.group_stats / tail_latency
    thr = np.zeros(N)
    tails = np.zeros((len(qs), N))
    for pi, d in enumerate(per):
        lo, n = d["offset"], d["n"]
        lat_pt = lat_op[lo:lo + n]
        t0_pt = flat["t0"][lo:lo + n]
        end_pt = t0_pt + lat_pt
        rates = []
        s = lo
        for ln in d["seg_len"]:
            span = (end_pt[s - lo:s - lo + ln].max()
                    - t0_pt[s - lo:s - lo + ln].min())
            if span > 0:
                rates.append(ln / span)
            s += ln
        thr[pi] = sum(rates) / len(rates) if rates else 0.0
        if qs:
            tails[:, pi] = np.percentile(lat_pt, qs)
    cols["throughput"] = thr
    for q, t in zip(qs, tails):
        cols[f"p{q:g}_latency"] = t
    wall = walltime() - t_wall
    return SweepResult(points, cols, wall,
                       dict(device=str(dev), host_s=wall - device_s,
                            plan_s=plan_s, device_s=device_s, grid=(R, Ls)))


# ===================================================== closed-loop sweep
def _closed_point_build(p: SweepPoint, seed: int, dm: _DelayModel,
                        capacity: int, virtual_nodes: int) -> dict:
    """Host-side build of one closed-loop point: the exact schedules,
    routes, and per-op delay components a ``SimEdgeKV(engine="fast")``
    closed-loop run would use (shared extraction:
    :func:`~repro_torch.sim.cluster.closed_loop_plan` +
    :func:`~repro_torch.sim.vectorized.plan_columns`), flattened in (thread,
    op) order — the order that defines heap pid tie-breaks."""
    plan = closed_loop_plan([(gi, f"g{gi}", p.group_size)
                             for gi in range(p.groups)],
                            p.threads, p.ops,
                            dict(p_global=p.p_global,
                                 distribution=p.distribution,
                                 n_records=p.n_records), seed)
    cols = plan_columns(plan, lambda gid: int(gid[1:]))
    client, key_idx = cols["client"], cols["key_idx"]
    bounds = cols["bounds"]
    n = int(bounds[-1])
    is_w = cols["kind"] != READ_CODE
    glob = cols["dtype"] == GLOBAL_CODE
    serving = client.copy()
    hops = np.zeros(n, np.int32)
    if glob.any():
        topo = _topology(p.groups, virtual_nodes)
        owner, h = topo.routes(client[glob], key_idx[glob],
                               plan[0].wl.keys)
        serving[glob] = owner
        hops[glob] = h
    lf = (~glob) & cols["fwd"]
    remote = glob & (serving != client)

    def bw(pair):
        return np.where(is_w, pair[1], pair[0])

    first = np.zeros(n, bool)
    first[bounds[:-1]] = True
    flat = dict(
        c_req=bw(dm.c_req), f_req=bw(dm.f_req), sg_req=bw(dm.sg_req),
        h_req=bw(dm.h_req), sg_resp=bw(dm.sg_resp), g_resp=bw(dm.g_resp),
        f_resp=bw(dm.f_resp), c_resp=bw(dm.c_resp),
        svc_base=np.where(is_w, dm.svc_base[1], dm.svc_base[0]),
        q_ri=np.where(is_w, dm.quorum(p.group_size),
                      dm.readindex(p.group_size)),
        lf=lf, glob=glob, remote=remote, first=first, hops=hops,
        pred=np.maximum(np.arange(n, dtype=np.int64) - 1, 0),
        key=key_idx.astype(np.int64))

    # one row per serving group; a stable sort keyed by serving group
    # keeps members in ascending flat index = (pid, op) order, which is
    # what breaks exact arrival ties the way the heap engine's
    # (arrival, pid) tuples do
    order = np.argsort(serving, kind="stable")
    sv = serving[order]
    cuts = np.flatnonzero(sv[1:] != sv[:-1]) + 1
    rows: List[np.ndarray] = []
    evict = False
    for members in (np.split(order, cuts) if n else []):
        rows.append(members.astype(np.int64))
        # eviction is order-independent: a leader's LRU can only evict
        # when it ever holds more distinct keys than its capacity
        if np.unique(key_idx[members]).size > capacity:
            evict = True
    return dict(flat=flat, rows=rows, n=n, client=client, is_w=is_w,
                glob=glob, hops=hops, evict=evict,
                per_thread=max(1, p.ops // max(1, p.threads)),
                max_hops=int(hops.max()) if n else 0)


def _closed_assemble(blocks: Sequence[dict]) -> dict:
    """Concatenate per-point builds into one device block, rebasing the
    flat op index space (``pred`` and row members shift by offset)."""
    flat: Dict[str, np.ndarray] = {}
    for k in blocks[0]["flat"]:
        parts, off = [], 0
        for b in blocks:
            v = b["flat"][k]
            parts.append(v + off if k == "pred" else v)
            off += b["n"]
        flat[k] = np.concatenate(parts)
    rows: List[np.ndarray] = []
    off = 0
    for b in blocks:
        rows.extend(m + off for m in b["rows"])
        off += b["n"]
    return dict(flat=flat, rows=rows, n=off)


def _closed_pad(blk: dict, n_max: int, R_max: int, Ls_max: int
                ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Pad one device block to the fleet-wide shapes and precompute the
    static queue geometry the round program exploits.

    Row membership and keys never change across rounds — only arrival
    *values* do — so everything except the order within each row is
    known here, on the host, once:

    * ``row``  — each op's row (queue) id; pad ops get the one-past-end
      row so a single stable composite sort by ``(row, arrival)`` in op
      space replaces the padded per-row argsort (real ops only — no
      O(R*Ls) slot padding in the sort).
    * ``rank``/``dest`` — sorted *position* -> (queue rank, slot in the
      rectangular scan grid).  Row sizes are static, so position ``p``
      always lands in the same row at the same rank; the sorted
      arrivals scatter into the (R, Ls) max-plus grid through these
      static indices (pad positions index out of bounds and drop).
    * ``seg``  — segment id of each op's (row, key) group, so the
      seen-before LRU mask reduces to one ``segment_min`` over queue
      ranks instead of a sort-by-key round trip.

    Padding is inert by construction: pad ops are first-ops with
    all-zero delay columns (their completions converge to a constant in
    one round), sort after every real row, and never enter the scan
    grid — their departures gather the out-of-bounds fill."""
    n, pad = blk["n"], n_max - blk["n"]
    flat = {}
    for k, v in blk["flat"].items():
        if pad:
            fill = np.full(pad, k == "first") if v.dtype == bool \
                else np.zeros(pad, v.dtype)
            v = np.concatenate([v, fill])
        flat[k] = v
    flat["pred"] = flat["pred"].astype(np.int32)
    row_of = np.full(n_max, R_max, np.int32)
    rank = np.zeros(n_max, np.int32)
    dest = np.full(n_max, R_max * Ls_max, np.int32)
    off = 0
    for r, m in enumerate(blk["rows"]):
        row_of[m] = r
        rank[off:off + len(m)] = np.arange(len(m), dtype=np.int32)
        dest[off:off + len(m)] = r * Ls_max + np.arange(len(m),
                                                        dtype=np.int32)
        off += len(m)
    comp_key = (row_of.astype(np.int64) * (int(flat["key"].max()) + 2)
                + flat["key"] + 1)
    seg = np.unique(comp_key, return_inverse=True)[1].astype(np.int32)
    aux = dict(row=row_of, rank=rank, dest=dest, seg=seg)
    return flat, aux


def _closed_round(comp: torch.Tensor, flat: Dict[str, torch.Tensor],
                  aux: Dict[str, torch.Tensor], *, max_hops: int,
                  scan_backend: str, seek: float, R: int, Ls: int,
                  pieces: Optional[list] = None) -> torch.Tensor:
    """One round of the closed-loop fixed point: completions in, the next
    completions out, every op at once (one device block)."""
    n = comp.shape[0]
    f64, dev = comp.dtype, comp.device
    zero = torch.zeros((), dtype=f64, device=dev)
    # take(mode="clip") has no torch twin: clamp the indices instead
    pred = flat["pred"].long().clamp(0, n - 1)
    t0 = torch.where(flat["first"], zero, comp[pred])
    cuts = [] if pieces is not None else None
    arr = arrival_chain(torch, t0, flat["c_req"], flat["f_req"],
                        flat["sg_req"], flat["h_req"], flat["lf"],
                        flat["glob"], flat["hops"], max_hops, cuts=cuts)
    # one stable composite sort of the real ops by (row, arrival)
    # recovers every leader queue at once: stability breaks exact arrival
    # ties by flat index = (pid, op) order, the heap engine's tie-break,
    # and pad ops sort after every real row.  torch sorts by one key, so
    # the composite sort is two stable passes: by arrival, then by row
    by_arr = torch.sort(arr, stable=True).indices
    perm = by_arr[torch.sort(aux["row"][by_arr], stable=True).indices]
    arr_ord = arr[perm]
    # seen-before page penalties (the no-eviction LRU regime): an op hits
    # iff a same-key op sits earlier in its queue, i.e. its rank exceeds
    # the min rank of its static (row, key) segment; ranks per sorted
    # position are static (row sizes don't change).  segment_min is a
    # scatter-reduce "amin" (order-independent, so deterministic)
    seg_ord = aux["seg"][perm].long()
    rmin = torch.zeros(n, dtype=aux["rank"].dtype, device=dev).scatter_reduce(
        0, seg_ord, aux["rank"], "amin", include_self=False)
    pens = torch.where(aux["rank"] > rmin[seg_ord], zero,
                       torch.full((), seek, dtype=f64, device=dev))
    svc_ord = flat["svc_base"][perm] + pens
    # leader FIFO commit stage: scatter the ordered queues into the
    # rectangular (R, Ls) grid through the static position -> slot map
    # (uncovered slots stay +inf/0 and are never gathered back) and run
    # the batched max-plus departure scan.  .at[dest].set(mode="drop")
    # has no torch twin: only the in-range positions (aux["keep"]) are
    # written, through unique slots, so the scatter is deterministic.
    # "seq" reproduces the engine's exact sequential float association
    # (required for the <=1e-9 differential contract — see run_sweep);
    # the closed-form backends are ulp-reassociated
    keep, slot = aux["keep"], aux["slot"]
    grid_a = torch.full((R * Ls,), torch.inf, dtype=f64, device=dev)
    grid_a[slot] = arr_ord[keep]
    grid_s = torch.zeros(R * Ls, dtype=f64, device=dev)
    grid_s[slot] = svc_ord[keep]
    grid_a, grid_s = grid_a.view(R, Ls), grid_s.view(R, Ls)
    if scan_backend == "cuda":
        dep_grid = maxplus_depart(grid_a, grid_s, backend="cuda")
    elif scan_backend == "assoc":
        dep_grid = maxplus_depart(grid_a, grid_s, backend="assoc")
    else:
        dep_grid = maxplus_depart(grid_a, grid_s, backend="ref")

    def gather(grid):
        # take(mode="fill", fill_value=0.0): out-of-range positions read
        # 0.0; the scatter back through the permutation is deterministic
        # (its indices are unique)
        ordv = torch.zeros(n, dtype=f64, device=dev)
        ordv[keep] = grid.reshape(-1)[slot]
        out = torch.zeros(n, dtype=f64, device=dev)
        out[perm] = ordv
        return out
    dep = gather(dep_grid)
    ccuts = [] if pieces is not None else None
    new = completion_chain(torch, dep, flat["q_ri"], flat["sg_resp"],
                           flat["g_resp"], flat["f_resp"], flat["c_resp"],
                           flat["lf"], flat["glob"], flat["remote"],
                           cuts=ccuts)
    if pieces is not None:
        # span-model pieces: service start = max(arrival, previous
        # departure) per queue slot, clamped to the departure (the
        # closed-form scan backends may reassociate by an ulp)
        prev = torch.cat([torch.full((R, 1), -torch.inf, dtype=f64,
                                     device=dev), dep_grid[:, :-1]], dim=1)
        start = gather(torch.minimum(torch.maximum(grid_a, prev), dep_grid))
        pieces.extend([cuts[0], cuts[1], arr, start, dep, ccuts[0]])
    return new


def _closed_fixed_point(blocks: Sequence[Tuple[Dict[str, torch.Tensor],
                                               Dict[str, torch.Tensor]]],
                        *, max_hops: int, scan_backend: str,
                        max_rounds: int, seek: float, R: int, Ls: int
                        ) -> List[tuple]:
    """Iterate rounds to the fixed point on every device block.

    The blocks step in lockstep, each stopping at its own fixed point:
    a round of every unfinished block is queued before any block's
    "nothing changed" test waits on its device, so blocks on different
    GPUs overlap.  Past a block's fixed point its round map is
    idempotent, so stopping a block early or late changes no bit.

    Returns per block ``(comp, t0, done, rounds, pieces)``: completions,
    start times, whether a round changed nothing within ``max_rounds``,
    the rounds run, and the span pieces ``(b_request, b_route, arrival,
    start, departure, b_replicate)`` stacked (6, n).
    """
    kw = dict(max_hops=max_hops, scan_backend=scan_backend, seek=seek,
              R=R, Ls=Ls)
    auxs, comps = [], []
    for flat, aux in blocks:
        # static scatter geometry: positions whose slot lies in the grid
        dest = aux["dest"].long()
        keep = torch.nonzero(dest < R * Ls).squeeze(1)
        auxs.append(dict(aux, keep=keep, slot=dest[keep]))
        comps.append(torch.full(flat["c_req"].shape, torch.inf,
                                dtype=torch.float64,
                                device=flat["c_req"].device))
    done = [False] * len(blocks)
    rounds = [0] * len(blocks)
    live = list(range(len(blocks)))
    # lax.while_loop becomes a host loop: one device sync per block and
    # round to test "nothing changed", the test the reference program makes
    while live:
        new = {d: _closed_round(comps[d], blocks[d][0], auxs[d], **kw)
               for d in live}
        for d in live:
            done[d] = torch.equal(new[d], comps[d])
            comps[d] = new[d]
            rounds[d] += 1
        live = [d for d in live if not done[d] and rounds[d] < max_rounds]
    out = []
    for (flat, _), aux, comp, ok, r in zip(blocks, auxs, comps, done,
                                           rounds):
        n = comp.shape[0]
        t0 = torch.where(flat["first"],
                         torch.zeros((), dtype=torch.float64,
                                     device=comp.device),
                         comp[flat["pred"].long().clamp(0, n - 1)])
        # one idempotent replay of the converged round keeps the pieces
        pieces: list = []
        _closed_round(comp, flat, aux, pieces=pieces, **kw)
        out.append((comp, t0, ok, r, torch.stack(pieces)))
    return out


def _block_devices(device: torch.device, devices: int, D: int
                   ) -> List[torch.device]:
    """Where each of the ``D`` point blocks runs.  On the CPU every block
    runs on the host, in turn.  On CUDA block ``d`` runs on its own GPU,
    ``cuda:i+d``, ``i`` being ``device``'s index (the current device
    when it names none); ``devices`` GPUs from ``cuda:i`` on must be
    visible, or this raises ``ValueError``."""
    if device.type != "cuda":
        return [device] * D
    count = torch.cuda.device_count()
    first = (torch.cuda.current_device() if device.index is None
             else device.index)
    if first + devices > count:
        raise ValueError(
            f"devices={devices} from cuda:{first} but only {count} CUDA "
            "devices visible; each point block runs on its own GPU")
    return [torch.device("cuda", first + d) for d in range(D)]


def _closed_rounds_host(built: Sequence[dict], capacity: int, seek: float,
                        max_hops: int, max_rounds: int
                        ) -> Tuple[List[np.ndarray], List[np.ndarray],
                                   List[np.ndarray]]:
    """Host-side fixed point for grids in the eviction regime: same
    rounds, same float64 expressions, but page penalties come from the
    exact LRU replay (:func:`~repro_torch.sim.vectorized.lru_hit_mask`, stack
    distances and all) instead of the in-program seen-before mask.

    Also returns the span-model pieces ``(b_request, b_route, arrival,
    start, departure, b_replicate)`` stacked per point: the round that
    detects convergence recomputes them from the already-converged
    completions, so its intermediates ARE the fixed point's.
    """
    comp_pt, t0_pt, pieces_pt = [], [], []
    for b in built:
        flat, n = b["flat"], b["n"]
        comp = np.full(n, np.inf)
        t0 = np.zeros(n)
        for _ in range(max_rounds):
            t0 = np.where(flat["first"], 0.0, comp[flat["pred"]])
            cuts: list = []
            arr = arrival_chain(np, t0, flat["c_req"], flat["f_req"],
                                flat["sg_req"], flat["h_req"],
                                flat["lf"], flat["glob"], flat["hops"],
                                max_hops, cuts=cuts)
            dep = np.zeros(n)
            start = np.zeros(n)
            for m in b["rows"]:
                order = m[np.argsort(arr[m], kind="stable")]
                hitm = lru_hit_mask(flat["key"][order], capacity)
                svc = flat["svc_base"][order] + np.where(hitm, 0.0, seek)
                arr_o = arr[order].tolist()
                svc_o = svc.tolist()
                dep_o = np.empty(len(order))
                start_o = np.empty(len(order))
                d = -np.inf
                # sequential recurrence in the engine's exact float
                # order (start = max(a, free); dep = start + svc) —
                # the closed-form numpy scan reassociates and its ulp
                # drift can flip near-tied queue orders across rounds
                for j, (a_j, s_j) in enumerate(zip(arr_o, svc_o)):
                    st = a_j if a_j > d else d
                    start_o[j] = st
                    d = st + s_j
                    dep_o[j] = d
                dep[order] = dep_o
                start[order] = start_o
            ccuts: list = []
            new = completion_chain(np, dep, flat["q_ri"],
                                   flat["sg_resp"], flat["g_resp"],
                                   flat["f_resp"], flat["c_resp"],
                                   flat["lf"], flat["glob"],
                                   flat["remote"], cuts=ccuts)
            if np.array_equal(new, comp):
                break
            comp = new
        else:
            raise RuntimeError(
                f"closed-loop sweep did not converge in {max_rounds} "
                "rounds (host/LRU path); raise max_rounds")
        comp_pt.append(comp)
        t0_pt.append(t0)
        pieces_pt.append(np.stack([cuts[0], cuts[1], arr, start, dep,
                                   ccuts[0]]))
    return comp_pt, t0_pt, pieces_pt


def _run_closed(points: List[SweepPoint], *, setting: str, seed: int,
                service: Optional[ServiceParams], virtual_nodes: int,
                scan_backend: str, percentiles: Sequence[float],
                devices: int, max_rounds: Optional[int],
                device: torch.device) -> SweepResult:
    t_wall = walltime()
    for p in points:
        if p.threads < 1 or p.ops < 1:
            raise ValueError(
                "closed-loop points need threads >= 1 and ops >= 1")
    svcp = service or ServiceParams()
    dm = _DelayModel(SETTINGS[setting], svcp)
    capacity = max(1, svcp.page_cache_keys)
    qs = tuple(float(q) for q in percentiles)

    built = [_closed_point_build(p, seed, dm, capacity, virtual_nodes)
             for p in points]
    max_hops = max(b["max_hops"] for b in built)
    if max_rounds is None:
        # the resolved wavefront advances >= 1 op per thread per round;
        # the slack covers order corrections rippling between threads
        max_rounds = 4 * max(b["per_thread"] for b in built) + 64
    seek = float(dm.seek)
    info: Dict[str, object] = dict(device=str(device), device_s=0.0,
                                   rounds=None, grid=None, blocks=None)

    if any(b["evict"] for b in built):
        info["plan_s"] = walltime() - t_wall
        comp_pt, t0_pt, pieces_pt = _closed_rounds_host(
            built, capacity, seek, max_hops, max_rounds)
    else:
        # deal the points round-robin into D blocks, one a device, each
        # padded to the common (n, R, Ls) as the reference pads its
        # shards; D = 1 is one block with no padding
        D = min(devices, len(points))
        block_devs = _block_devices(device, devices, D)
        idxs = [range(d, len(points), D) for d in range(D)]
        blks = [_closed_assemble([built[pi] for pi in ix]) for ix in idxs]
        n_max = max(b["n"] for b in blks)
        R_max = max(len(b["rows"]) for b in blks)
        Ls_max = max(len(m) for b in blks for m in b["rows"])
        padded = [_closed_pad(b, n_max, R_max, Ls_max) for b in blks]
        t_dev = walltime()
        info["plan_s"] = t_dev - t_wall
        outs = _closed_fixed_point(
            [(to_device(f, dv), to_device(a, dv))
             for (f, a), dv in zip(padded, block_devs)],
            max_hops=max_hops, scan_backend=scan_backend,
            max_rounds=int(max_rounds), seek=seek, R=R_max, Ls=Ls_max)
        outs = [(_host(c), _host(t), ok, r, _host(pc))
                for c, t, ok, r, pc in outs]
        info.update(device_s=walltime() - t_dev,
                    rounds=max(o[3] for o in outs), grid=(R_max, Ls_max),
                    blocks=D)
        if not all(o[2] for o in outs):
            raise RuntimeError(
                f"closed-loop sweep did not converge in {max_rounds} "
                "rounds; raise max_rounds")
        comp_pt = [np.empty(0)] * len(points)
        t0_pt = [np.empty(0)] * len(points)
        pieces_pt = [np.empty((6, 0))] * len(points)
        for ix, (comp, t0f, _, _, pieces) in zip(idxs, outs):
            off = 0
            for pi in ix:
                n = built[pi]["n"]
                comp_pt[pi] = comp[off:off + n]
                t0_pt[pi] = t0f[off:off + n]
                pieces_pt[pi] = pieces[:, off:off + n]
                off += n

    # ---- fold into per-point RecordArray-style aggregates ----
    N = len(points)
    names = ("mean_latency", "read_latency", "update_latency",
             "local_latency", "global_latency", "update_global_latency")
    cols: Dict[str, np.ndarray] = {
        "ops": np.asarray([b["n"] for b in built], np.int64)}
    for name in names:
        cols[name] = np.zeros(N)
    cols["throughput"] = np.zeros(N)
    cols["mean_hops"] = np.zeros(N)
    for stage in OBS_STAGES:
        cols[f"stage_{stage}"] = np.zeros(N)
    tails = np.zeros((len(qs), N))
    for pi, (p, b) in enumerate(zip(points, built)):
        lat = np.asarray(comp_pt[pi]) - np.asarray(t0_pt[pi])
        is_w, glob = b["is_w"], b["glob"]

        # per-stage mean durations from the converged round's pieces;
        # closed points have no lease stage, so that bound repeats
        # b_route (zero duration)
        b_req, b_route, arr, start, dep, b_repl = np.asarray(
            pieces_pt[pi], np.float64)
        bounds9 = (np.asarray(t0_pt[pi]), b_req, b_route, b_route, arr,
                   start, dep, b_repl, np.asarray(comp_pt[pi]))
        for si, stage in enumerate(OBS_STAGES):
            d = bounds9[si + 1] - bounds9[si]
            cols[f"stage_{stage}"][pi] = (float(d.mean()) if len(d)
                                          else float("nan"))

        def mean(m):
            return float(lat[m].mean()) if m.any() else float("nan")

        cols["mean_latency"][pi] = float(lat.mean())
        cols["read_latency"][pi] = mean(~is_w)
        cols["update_latency"][pi] = mean(is_w)
        cols["local_latency"][pi] = mean(~glob)
        cols["global_latency"][pi] = mean(glob)
        cols["update_global_latency"][pi] = mean(is_w & glob)
        cols["mean_hops"][pi] = float(b["hops"].mean())
        # paper-metric throughput: mean of per-client-group rates, spans
        # from the same t_start/latency expressions RecordArray
        # group_stats folds
        ends = np.asarray(t0_pt[pi]) + lat
        rates = []
        for gi in range(p.groups):
            m = b["client"] == gi
            if not m.any():
                continue
            span = ends[m].max() - np.asarray(t0_pt[pi])[m].min()
            if span > 0:
                rates.append(int(m.sum()) / span)
        cols["throughput"][pi] = (sum(rates) / len(rates) if rates
                                  else 0.0)
        if qs:
            tails[:, pi] = np.percentile(lat, qs)
    for q, t in zip(qs, tails):
        cols[f"p{q:g}_latency"] = t
    wall = walltime() - t_wall
    info["host_s"] = wall - info["device_s"]
    return SweepResult(points, cols, wall, info)

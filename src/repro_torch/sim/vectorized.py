"""Vectorized execution backend for :class:`repro_torch.sim.cluster.SimEdgeKV`.

The generator oracle steps ~10 heap events per operation (transfer
timeouts, resource acquire/release, response hops) through one Python
generator per client thread — tens of millions of events at fig scale.
This backend replaces all of that with batched array math plus one compact
scan, selected via ``SimEdgeKV(engine="fast")`` or
:class:`FastSimEdgeKV`.

Why almost everything is closed-form
------------------------------------
Per op, every delay except the leader stage is a *deterministic* function
of static op attributes: kind (request/response sizes), data type, the
pre-drawn forward coin, and the Chord route (hop count + owner), none of
which depend on other in-flight ops. So the client→storage→gateway
transfer chains, the quorum RTT (all follower RTTs are identical, so the
majority-th ack is a scalar per group size), and the ReadIndex round are
precomputed as numpy column expressions / per-profile component tuples.
Chord routes collapse too: a lookup path is a function of (start gateway,
the key's successor vnode) only, so one route per such class covers every
key in it.

The only true serialization points are

* each group leader's FIFO capacity-1 commit stage — op ``i``'s service
  start is ``max(arrival_i, departure_{i-1})``, a cumulative-max
  recurrence over ops in arrival order, and
* the leader's LRU page-cache hit/miss sequence, which depends on the
  *order* keys hit the leader.

For **open-loop** runs arrivals are exogenous (Poisson), so both resolve
in one per-group O(ops) pass: sort by arrival, replay the LRU once for the
penalties, then the max-plus departure scan ``dep_i = max(arr_i,
dep_{i-1}) + svc_i`` through :mod:`repro_torch.kernels.maxplus_scan` (numpy
closed form here; the same recurrence as a torch closed-form scan /
a CUDA kernel powers the batched sweep engine in
:mod:`repro_torch.sim.sweep`, which evaluates whole parameter grids as one
device array program built from the pure :func:`arrival_chain` /
:func:`completion_chain` delay columns below).  Open loop + churn runs
in the same pass: routing and write application are segmented at
membership events, the scan is not (the leader queue persists).
For **closed-loop** runs the next arrival of a thread depends on its
previous completion, so the same recurrence is evaluated online: a heap
holds exactly ONE event per op (its leader arrival) instead of ~10, and
all delay components around the scan come from the precomputed columns.

Exactness
---------
On closed-loop runs without churn the fast path reproduces the oracle's
``OpRecord`` stream *bit-for-bit* (same seed): both engines consume the
same :meth:`YCSBWorkload.batch_ops` schedules, the event engine breaks
virtual-time ties by process id (see :mod:`repro_torch.sim.events`), and delay
components are accumulated in exactly the order the oracle's Timeout
chain adds them (float addition is not associative, so component tuples
are added sequentially, never pre-summed). When membership can change
mid-run (churn or fault drivers, or a §7.2 location cache), closed-loop
global ops queue as **two-phase** heap events: a gateway-*lookup* event
at exactly the virtual time the oracle calls ``ring.route``, which
resolves the route against the then-current membership and only then
pushes the leader-arrival event — a crash or join therefore lands on the
same op boundary in both engines (the split adds the same delay terms in
the same order, so membership-free runs stay bit-exact). Open-loop and
churn/fault runs match statistically: numpy arrival streams replace
``random.expovariate``, and state writes apply at slightly different
pipeline stages (leader arrival vs post-quorum).
"""
from __future__ import annotations

import bisect
import heapq
from typing import Dict, Generator, List, Optional, Tuple

import numpy as np

from repro_torch.core.hashring import stable_hash
from repro_torch.core.kvstore import GLOBAL, LOCAL
from repro_torch.kernels.maxplus_scan import maxplus_depart

from .cluster import ACK_BYTES, SimEdgeKV, ThreadPlan
from .events import Timeout
from .ycsb import DTYPE_CODE, KIND_CODE, RECORD_BYTES, REQ_BYTES, YCSBWorkload

LOCAL_CODE = DTYPE_CODE["local"]
GLOBAL_CODE = DTYPE_CODE["global"]
READ_CODE = KIND_CODE["read"]
_VAL = ("v", RECORD_BYTES)


class FastSimEdgeKV(SimEdgeKV):
    """:class:`SimEdgeKV` pinned to the vectorized engine."""

    def __init__(self, **kw):
        kw["engine"] = "fast"
        super().__init__(**kw)


class _DelayModel:
    """Scalar delay components, indexed by ``is_write`` where sizes differ.

    Each value equals the argument of one oracle ``Timeout`` exactly (same
    arithmetic expression), so sequential addition reproduces the oracle's
    float accumulation.
    """

    def __init__(self, net, svc):
        req = (REQ_BYTES, REQ_BYTES + RECORD_BYTES)          # [is_write]
        resp = (REQ_BYTES + RECORD_BYTES, REQ_BYTES)
        self.c_req = tuple(net.xfer("cli_st", b) for b in req)
        self.c_resp = tuple(net.xfer("cli_st", b) for b in resp)
        self.f_req = tuple(net.xfer("st_st", b) for b in req)
        self.f_resp = tuple(net.xfer("st_st", b) for b in resp)
        self.sg_req = tuple(net.xfer("st_gw", b) for b in req)
        self.sg_resp = tuple(net.xfer("st_gw", b) for b in resp)
        self.h_req = tuple(net.xfer("gw_gw", b) + svc.gw_route_s for b in req)
        self.g_resp = tuple(net.xfer("gw_gw", b) for b in resp)
        self.svc_base = (svc.read_s, svc.commit_s)
        self.seek = svc.seek_s
        self._net = net
        self._svc = svc
        self._quorum: Dict[int, float] = {}
        self._readindex: Dict[int, float] = {}

    def quorum(self, n: int) -> float:
        """Majority-th follower ack after leader broadcast — all follower
        RTTs are identical, so the sorted-select collapses to a scalar."""
        q = self._quorum.get(n)
        if q is None:
            need = (n // 2 + 1) - 1
            q = 0.0 if need <= 0 else (
                self._net.xfer("st_st", RECORD_BYTES + ACK_BYTES)
                + self._svc.follower_append_s
                + self._net.xfer("st_st", ACK_BYTES))
            self._quorum[n] = q
        return q

    def readindex(self, n: int) -> float:
        r = self._readindex.get(n)
        if r is None:
            need = (n // 2 + 1) - 1
            r = 0.0 if need <= 0 else 2 * self._net.xfer("st_st", ACK_BYTES)
            self._readindex[n] = r
        return r


def _batch_routes(ring, gw_of_code: List[str],
                  owner_code_of_gw: Dict[str, int],
                  client_codes: np.ndarray, key_indices: np.ndarray,
                  keys: List[str]) -> Tuple[np.ndarray, np.ndarray]:
    """(owner_code, hops) for each (client group code, key index) row.

    One ``ring.route`` call per unique (gateway, successor-vnode) class —
    a Chord lookup path depends on the target only through its successor
    vnode, so a representative key per class routes for all of them.
    Takes the ring topology explicitly (not a sim); the sweep engine's
    :class:`repro_torch.sim.sweep._Topology` is the grid-memoized variant of
    this (keyspace hashes and route classes cached across points).
    """
    vh = np.asarray(ring._vhashes, dtype=np.uint64)
    uk = np.unique(key_indices)
    khash = np.fromiter((stable_hash(keys[int(k)]) for k in uk),
                        dtype=np.uint64, count=len(uk))
    pos = np.searchsorted(vh, khash, side="left") % len(vh)
    pos_of_key = np.zeros(int(key_indices.max()) + 1, dtype=np.int64)
    pos_of_key[uk] = pos
    svn = pos_of_key[key_indices]
    packed = client_codes.astype(np.int64) * len(vh) + svn
    uniq, uidx, inv = np.unique(packed, return_index=True,
                                return_inverse=True)
    owner_u = np.empty(len(uniq), np.int32)
    hops_u = np.empty(len(uniq), np.int32)
    for j in range(len(uniq)):
        rep = int(uidx[j])
        path = ring.route(gw_of_code[int(client_codes[rep])],
                          keys[int(key_indices[rep])])
        owner_u[j] = owner_code_of_gw[path[-1]]
        hops_u[j] = len(path) - 1
    return owner_u[inv], hops_u[inv]


class _FastEngine:
    """Closed-loop fast core: one heap event per op around the leader scan."""

    def __init__(self, sim: SimEdgeKV):
        self.sim = sim
        self.dm = _DelayModel(sim.net, sim.service)
        self._profiles: Dict[tuple, tuple] = {}
        # per-group-code tables (grown by _sync_groups on membership events)
        self.gid_of: List[str] = []
        self.n_of: List[int] = []
        self.free: List[float] = []
        self.busy: List[float] = []
        self.cache_d: List[dict] = []
        self.cache_cap: List[int] = []
        self.cache_hits: List[int] = []
        self.cache_miss: List[int] = []
        self.store_by_tier: Tuple[List[dict], List[dict]] = ([], [])
        self.gw_of: List[str] = []
        self._sync_groups()
        # (group code, successor-vnode) -> [owner, hops, read prof, write
        # prof]; cleared on membership change
        self.route_memo: Dict[Tuple[int, int], list] = {}
        self._khash: Dict[int, int] = {}      # key idx -> ring hash (stable)
        self._pos_memo: Dict[int, int] = {}   # key idx -> successor vnode
        self._home_memo: Dict[int, dict] = {}  # key idx -> owner store
        self._local_prof: Dict[tuple, tuple] = {}
        self.aux: Dict[int, Generator] = {}
        self.heap: List[tuple] = []
        self.last_time = 0.0
        # per-thread flag: True when the thread's queued heap event is a
        # leader *arrival*, False when it is the two-phase gateway
        # *lookup* of a dynamically-routed global op
        self.arrival_phase: List[bool] = []

    # ------------------------------------------------------------- groups
    def _sync_groups(self) -> None:
        sim = self.sim
        ids = sim.records._group_ids
        for c in range(len(self.gid_of), len(ids)):
            gid = ids[c]
            g = sim.groups[gid]
            self.gid_of.append(gid)
            self.n_of.append(g["n"])
            self.free.append(0.0)
            self.busy.append(0.0)
            self.cache_d.append(g["page_cache"]._d)
            self.cache_cap.append(g["page_cache"].capacity)
            self.cache_hits.append(0)
            self.cache_miss.append(0)
            self.store_by_tier[0].append(g["state"].stores[LOCAL])
            self.store_by_tier[1].append(g["state"].stores[GLOBAL])
            self.gw_of.append(sim.gateway_of_group[gid])

    # ----------------------------------------------------------- profiles
    def _profile(self, key: tuple) -> tuple:
        """(pre, svc_base, post) component tuples for one op shape.

        ``key`` = (dtype, is_write, fwd, hops, remote, n_serving). The
        tuples are added *sequentially* onto the running clock, mirroring
        the oracle's Timeout chain term by term.
        """
        prof = self._profiles.get(key)
        if prof is None:
            dtype, w, fwd, hops, remote, n = key
            dm = self.dm
            if dtype == LOCAL_CODE:
                pre = [dm.c_req[w]] + ([dm.f_req[w]] if fwd else [])
                post = [dm.quorum(n) if w else dm.readindex(n)]
                if fwd:
                    post.append(dm.f_resp[w])
                post.append(dm.c_resp[w])
            else:
                pre = ([dm.c_req[w], dm.sg_req[w]]
                       + [dm.h_req[w]] * hops + [dm.sg_req[w]])
                post = [dm.quorum(n) if w else dm.readindex(n), dm.sg_resp[w]]
                if remote:
                    post.append(dm.g_resp[w])
                post += [dm.sg_resp[w], dm.c_resp[w]]
            prof = self._profiles[key] = (tuple(pre), dm.svc_base[w],
                                          tuple(post))
        return prof

    # ----------------------------------------------------------- planning
    def load_plan(self, plan: List[ThreadPlan]) -> None:
        sim = self.sim
        cols = plan_columns(plan, sim.records.group_code)
        counts = cols["counts"]
        bounds = cols["bounds"]
        self.n_ops = n_ops = int(bounds[-1])
        self.thread_end = bounds[1:].tolist()
        self.cursor = bounds[:-1].tolist()
        self.client_code = cols["client"]
        self.key_idx = cols["key_idx"]
        self.kind = cols["kind"]
        self.dtype = cols["dtype"]
        self.fwd = cols["fwd"]
        self.is_w = (self.kind != READ_CODE)

        # aux processes (churn drivers) registered via env.process before
        # the run; worker pids continue the same counter, matching the
        # oracle's process-creation order
        self.aux = dict(sim.env.pending)
        sim.env.pending = []
        pid_base = sim.env._next_pid
        sim.env._next_pid += len(plan)
        self.op_pid = (np.repeat(np.arange(len(plan)), counts)
                       + pid_base).astype(np.int64) \
            if plan else np.empty(0, np.int64)

        # per-op key strings (shared key lists make this a gather)
        self.op_key: List[str] = []
        for tp in plan:
            keys = tp.wl.keys
            self.op_key.extend([keys[k] for k in tp.key_idx.tolist()])

        # Local ops never route, so their shapes are membership-independent
        # and always precomputable. Global ops go dynamic (two-phase
        # lookup events, resolved at gateway-lookup time) when the §7.2
        # location cache makes routing order-dependent OR any auxiliary
        # process (churn/fault/scenario driver) can change membership or
        # cut the network mid-run — a route (or refusal verdict) drawn
        # before such an event must not outlive it. Hot-key mirrors and
        # dispatch tracking resolve per op at the lookup instant too, so
        # they force the two-phase path as well.
        self.dynamic = (bool(sim.gw_cache) or bool(self.aux)
                        or bool(sim.partition_of) or bool(sim.hot_keys)
                        or sim.track_hot)
        # mirror-served reads complete at the gateway: read_s service
        # plus a constant (gw -> edge -> client) response chain
        self._mirror_post = (self.dm.sg_resp[0], self.dm.c_resp[0])
        # live-stats mode: completed-but-unflushed op indices, emitted
        # into sim.records at each aux-event boundary (see _flush_records)
        self._to_flush: List[int] = []
        self.serving: List[int] = self.client_code.tolist()
        self.hops: List[int] = [0] * n_ops
        self.op_pre: List[tuple] = [()] * n_ops
        self.op_svc: List[float] = [0.0] * n_ops
        self.op_post: List[tuple] = [()] * n_ops
        self._static_shapes(plan, globals_too=not self.dynamic)

        self._l_dtype = self.dtype.tolist()
        self._l_is_w = self.is_w.tolist()
        self._l_key_idx = self.key_idx.tolist()
        self._l_fwd = self.fwd.tolist()
        self._l_client = self.client_code.tolist()
        self.t_start = [0.0] * n_ops
        self.completion = [0.0] * n_ops
        self.latency = [0.0] * n_ops
        # span tracing: the 7 intermediate stage boundaries (b_end is the
        # completion column). NaN = stage not entered, filled forward at
        # finish — mirroring the oracle's fill_bounds
        self.trace = sim.records.stages
        self.b_cols: List[List[float]] = [
            [float("nan")] * n_ops for _ in range(7)] if self.trace else []

    def _static_shapes(self, plan: List[ThreadPlan],
                       globals_too: bool = True) -> None:
        """Batch-resolve op routes and delay profiles up front as numpy
        column expressions, valid for the membership at load time. With
        ``globals_too=False`` only local rows are shaped (a §7.2 location
        cache makes global routing order-dependent, so those stay lazy)."""
        if not self.n_ops:
            return
        glob = self.dtype == GLOBAL_CODE
        serving = self.client_code.copy()
        hops = np.zeros(self.n_ops, dtype=np.int32)
        if globals_too and glob.any():
            sim = self.sim
            owner_code = {gw: sim.records._group_code[g]
                          for g, gw in sim.gateway_of_group.items()}
            owner, h = _batch_routes(sim.ring, self.gw_of, owner_code,
                                     self.client_code[glob],
                                     self.key_idx[glob], plan[0].wl.keys)
            serving[glob] = owner
            hops[glob] = h
        remote = glob & (serving != self.client_code)
        n_serving = np.asarray(self.n_of, dtype=np.int32)[serving]
        shape_cols = np.stack(
            [self.dtype.astype(np.int32), self.is_w.astype(np.int32),
             self.fwd.astype(np.int32), hops, remote.astype(np.int32),
             n_serving], axis=1)
        uniq_shapes, inv = np.unique(shape_cols, axis=0, return_inverse=True)
        profs = [self._profile((int(r[0]), int(r[1]), bool(r[2]), int(r[3]),
                                bool(r[4]), int(r[5])))
                 for r in uniq_shapes]
        inv_l = inv.tolist()
        self.op_pre = [profs[c][0] for c in inv_l]
        self.op_svc = [profs[c][1] for c in inv_l]
        self.op_post = [profs[c][2] for c in inv_l]
        self.serving = serving.tolist()
        self.hops = hops.tolist()

    def _resolve(self, i: int) -> None:
        """Lazy shape resolution at op-schedule time, against the *current*
        ring membership and gateway location caches."""
        sim = self.sim
        d = self._l_dtype[i]
        w = self._l_is_w[i]
        gc = self._l_client[i]
        if d == LOCAL_CODE:
            lkey = (gc, w, self._l_fwd[i])
            prof = self._local_prof.get(lkey)
            if prof is None:
                prof = self._local_prof[lkey] = self._profile(
                    (d, w, self._l_fwd[i], 0, False, self.n_of[gc]))
            self.serving[i] = gc
        elif sim.gw_cache:
            key = self.op_key[i]
            gw = self.gw_of[gc]
            cached = sim.gw_cache[gw].get(key)
            if cached is not None:
                owner_gw, hops = cached, (0 if cached == gw else 1)
            else:
                path = sim.ring.route(gw, key)
                owner_gw, hops = path[-1], len(path) - 1
                sim.gw_cache[gw].put(key, owner_gw)
            owner = sim.records.group_code(sim.group_of_gateway[owner_gw])
            self.serving[i] = owner
            self.hops[i] = hops
            prof = self._profile((d, w, False, hops, owner != gc,
                                  self.n_of[owner]))
        else:
            ki = self._l_key_idx[i]
            p = self._pos_memo.get(ki)
            if p is None:
                kh = self._khash.get(ki)
                if kh is None:
                    kh = self._khash[ki] = stable_hash(self.op_key[i])
                vhs = sim.ring._vhashes
                p = bisect.bisect_left(vhs, kh)
                if p == len(vhs):
                    p = 0
                self._pos_memo[ki] = p
            ent = self.route_memo.get((gc, p))
            if ent is None:
                path = sim.ring.route(self.gw_of[gc], self.op_key[i])
                owner = sim.records.group_code(sim.group_of_gateway[path[-1]])
                ent = self.route_memo[(gc, p)] = [owner, len(path) - 1,
                                                  None, None]
            owner = ent[0]
            prof = ent[2 + w]
            if prof is None:
                prof = ent[2 + w] = self._profile(
                    (d, w, False, ent[1], owner != gc, self.n_of[owner]))
            self.serving[i] = owner
            self.hops[i] = ent[1]
        self.op_pre[i], self.op_svc[i], self.op_post[i] = prof

    # ---------------------------------------------------------------- run
    def _flush_records(self, t: float) -> None:
        """Live-stats mode: emit every completed-but-unflushed op with
        completion <= ``t`` into ``sim.records``. An op's completion is
        computed at its leader-arrival event (which precedes it in
        virtual time), so once the heap has advanced to ``t`` the flushed
        prefix equals the oracle's append-at-completion record stream —
        an aux process (the rebalance controller) sampling cached
        group_stats mid-run sees the same feedback signal on both
        engines. Batches stay (completion, pid)-sorted and successive
        batches cover disjoint ascending completion ranges, so the final
        record order matches the bulk path bit-for-bit."""
        pend = self._to_flush
        comp = self.completion
        ready = [j for j in pend if comp[j] <= t]
        if not ready:
            return
        pend[:] = [j for j in pend if comp[j] > t]  # alias-safe in run()
        self._emit(np.asarray(ready, dtype=np.int64))

    def _emit(self, idx: np.ndarray) -> None:
        """Append the records for op indices ``idx`` in (completion, pid)
        order — the oracle's completion-event execution order."""
        comp = np.asarray(self.completion)[idx]
        order = idx[np.lexsort((self.op_pid[idx], comp))]
        bounds = None
        if self.trace:
            prev = np.asarray(self.t_start)[order]
            bounds = []
            for col in self.b_cols:
                filled = np.asarray(col)[order]
                nan = np.isnan(filled)
                if nan.any():
                    filled = np.where(nan, prev, filled)
                bounds.append(filled)
                prev = filled
            bounds.append(np.asarray(self.completion)[order])
        self.sim.records.extend_columns(
            np.asarray(self.t_start)[order],
            np.asarray(self.latency)[order],
            self.kind[order], self.dtype[order],
            self.client_code[order],
            np.asarray(self.hops, dtype=np.int32)[order],
            bounds=bounds)

    def _step_aux(self, pid: int, t: float) -> None:
        sim = self.sim
        sim.env.now = t
        if t > self.last_time:
            self.last_time = t
        if sim.live_stats and self._to_flush:
            # the aux process may sample records/stats: surface every op
            # that has completed by now, before stepping the generator
            self._flush_records(t)
        gen = self.aux[pid]
        epoch = sim.churn_epoch
        try:
            ev = gen.send(None)
        except StopIteration:
            del self.aux[pid]
        else:
            if not isinstance(ev, Timeout):
                raise TypeError(
                    "fast-engine auxiliary processes may only yield Timeout")
            heapq.heappush(self.heap, (t + ev.delay, pid, -1))
        if sim.churn_epoch != epoch:
            self._sync_groups()
            self.route_memo.clear()
            self._pos_memo.clear()
            self._home_memo.clear()

    def run(self) -> None:
        sim = self.sim
        heap = self.heap
        cursor, thread_end = self.cursor, self.thread_end
        op_pre, op_svc, op_post = self.op_pre, self.op_svc, self.op_post
        op_pid = self.op_pid.tolist()
        serving, op_key = self.serving, self.op_key
        free, busy = self.free, self.busy
        cache_d, cache_cap = self.cache_d, self.cache_cap
        cache_hits, cache_miss = self.cache_hits, self.cache_miss
        stores = self.store_by_tier
        dtypes, is_w, l_key_idx = self._l_dtype, self._l_is_w, self._l_key_idx
        t_start, completion, latency = \
            self.t_start, self.completion, self.latency
        dm = self.dm
        seek = dm.seek
        churn_events = sim.churn_events
        unavail = sim.unavailable  # shared ref, mutated in place by faults
        leases = sim.leases        # shared ref, mutated by async handoff
        hstats = sim.handoff_stats
        group_code = sim.records._group_code
        pull_xfer = sim.net.xfer("gw_gw", RECORD_BYTES + REQ_BYTES)
        home_memo, khash = self._home_memo, self._khash
        dynamic = self.dynamic
        live = sim.live_stats
        to_flush = self._to_flush
        pop, push = heapq.heappop, heapq.heappush
        max_completion = 0.0
        arrival_phase = self.arrival_phase = [True] * len(cursor)
        trace = self.trace
        if trace:
            b_req, b_route, b_lease, b_ingr, b_queue, b_svc, b_repl = \
                self.b_cols

        # Two-phase dynamic routing: once membership can change mid-run
        # (location caches, churn, faults), a global op's route must
        # resolve at its *gateway lookup* time — where the oracle calls
        # ring.route — not when its predecessor completes. The op is
        # queued as a lookup event (t_start -> client link -> st-gw), and
        # only on popping it is the route resolved and the leader-arrival
        # event pushed. The split adds the same delay components in the
        # same order, so runs whose membership never changes stay
        # bit-exact with the single-phase path.
        def push_op(i: int, tau: int, t0c: float) -> None:
            t_start[i] = t0c
            if dtypes[i] and dynamic:
                w = is_w[i]
                tl = t0c + dm.c_req[w]
                tl += dm.sg_req[w]
                if trace:
                    b_req[i] = tl
                arrival_phase[tau] = False
                push(heap, (tl, op_pid[i], tau))
                return
            a = t0c
            if trace and dtypes[i]:
                # static global op: the pre tuple is
                # [c_req, sg_req] + [h_req]*hops + [sg_req] — same adds
                # as below, sampling the span cuts on the way
                pre = op_pre[i]
                a += pre[0]
                a += pre[1]
                b_req[i] = a                    # after gateway admit
                for comp in pre[2:-1]:
                    a += comp
                b_route[i] = b_lease[i] = a     # after overlay hops
                a += pre[-1]
                b_ingr[i] = a                   # after gw -> leader
            else:
                for comp in op_pre[i]:
                    a += comp
                if trace:
                    b_req[i] = a                # local: cli (+fwd) done
            arrival_phase[tau] = True
            push(heap, (a, op_pid[i], tau))

        # start events: aux processes first (they were created first), then
        # every thread's first op — at the current virtual time, matching
        # the oracle when a sim is driven more than once
        base = sim.env.now
        for pid in self.aux:
            heap.append((base, pid, -1))
        heapq.heapify(heap)
        for tau in range(len(cursor)):
            i = cursor[tau]
            if i < thread_end[tau]:
                push_op(i, tau, base)

        # live-stats mode defers each global write's store mutation to a
        # dedicated heap event at its replicate instant — the virtual
        # time the oracle's _group_write applies it — so an aux observer
        # (the rebalance controller) samples identical store snapshots
        # on both engines. One pending apply per thread, max: the
        # thread's next op starts at completion >= the apply instant.
        apply_key: List[Optional[str]] = [None] * len(cursor)
        apply_ki = [0] * len(cursor)
        apply_g = [0] * len(cursor)

        while heap:
            a, pid, tau = pop(heap)
            if tau < 0:
                if tau == -1:
                    self._step_aux(pid, a)
                    continue
                # deferred global write apply (encoded tau = -2 - thread)
                th = -2 - tau
                key = apply_key[th]
                apply_key[th] = None
                if churn_events:
                    ki = apply_ki[th]
                    store = home_memo.get(ki)
                    if store is None:
                        kh = khash.get(ki)
                        if kh is None:
                            kh = khash[ki] = stable_hash(key)
                        owner_gid = sim.group_of_gateway[
                            sim.ring.locate_hash(kh)]
                        store = home_memo[ki] = \
                            sim.groups[owner_gid]["state"].stores[GLOBAL]
                    store[key] = _VAL
                    if unavail:
                        unavail.pop(key, None)
                else:
                    stores[1][apply_g[th]][key] = _VAL
                continue
            i = cursor[tau]
            if not arrival_phase[tau]:
                # gateway lookup of a dynamically-routed global op:
                # resolve against the membership in force NOW, then queue
                # the leader arrival (remaining request-chain terms)
                if sim.partition_of:
                    w = is_w[i]
                    cgid = self.gid_of[self._l_client[i]]
                    code = sim._refusal_code(cgid, op_key[i], w)
                    if code:
                        # split-brain refusal at the lookup instant
                        # (oracle hook position): error ack chain back,
                        # no route resolution, no leader time, hops=0
                        sim._count_refusal(cgid, w, code)
                        c = a + dm.sg_req[0]
                        c += dm.c_req[0]
                        latency[i] = c - t_start[i]
                        completion[i] = c
                        if c > max_completion:
                            max_completion = c
                        if live:
                            to_flush.append(i)
                        nxt = i + 1
                        if nxt < thread_end[tau]:
                            cursor[tau] = nxt
                            push_op(nxt, tau, c)
                        continue
                # hot-key hooks at the gateway-admit instant — same
                # virtual-time position as the oracle's client_op hooks
                # (after the split-brain check, before route resolution)
                if sim.track_hot:
                    k = op_key[i]
                    sim.hot_track[k] = sim.hot_track.get(k, 0) + 1
                if sim.hot_keys:
                    k = op_key[i]
                    if is_w[i]:
                        if k in sim.hot_keys:
                            # write linearizes through the owner: revoke
                            # the read replica before the op proceeds
                            sim.hot_keys.discard(k)
                            sim.hot_stats["invalidated"] += 1
                    elif k in sim.hot_keys:
                        # mirror read: served by the replica at the
                        # client's own gateway — no overlay hops, no
                        # leader queue, no ReadIndex (the oracle's
                        # mirror branch, same delay terms)
                        sim.hot_stats["mirror_reads"] += 1
                        self.hops[i] = 0
                        c = a + dm.svc_base[0]
                        if trace:
                            b_route[i] = b_lease[i] = b_ingr[i] = a
                            b_queue[i] = a
                            b_svc[i] = c
                        c += self._mirror_post[0]
                        c += self._mirror_post[1]
                        latency[i] = c - t_start[i]
                        completion[i] = c
                        if c > max_completion:
                            max_completion = c
                        if live:
                            to_flush.append(i)
                        nxt = i + 1
                        if nxt < thread_end[tau]:
                            cursor[tau] = nxt
                            push_op(nxt, tau, c)
                        continue
                self._resolve(i)
                w = is_w[i]
                h = dm.h_req[w]
                for _ in range(self.hops[i]):
                    a += h
                if trace:
                    b_route[i] = b_lease[i] = a
                a += dm.sg_req[w]
                if trace:
                    b_ingr[i] = a
                arrival_phase[tau] = True
                push(heap, (a, pid, tau))
                continue
            if sim.partition_straddle and not dtypes[i] and \
                    sim._group_side(self.gid_of[self._l_client[i]]) is None:
                # straddled client group with no replica majority on
                # either side: local quorum ops refuse at the leader
                # arrival instant (oracle hook position)
                cgid = self.gid_of[self._l_client[i]]
                sim._count_refusal(cgid, is_w[i], 2)
                c = a
                if self._l_fwd[i]:
                    c += dm.f_req[0]
                c += dm.c_req[0]
                latency[i] = c - t_start[i]
                completion[i] = c
                if c > max_completion:
                    max_completion = c
                if live:
                    to_flush.append(i)
                nxt = i + 1
                if nxt < thread_end[tau]:
                    cursor[tau] = nxt
                    push_op(nxt, tau, c)
                continue
            if leases and dtypes[i]:
                # lease-resolution phase (third heap phase): a global op
                # whose key is mid-migration resolves against the lease
                # table at its leader-arrival instant — mirroring where
                # the oracle's generator hits the lease hook
                lease = leases.get(op_key[i])
                if lease is not None:
                    w = is_w[i]
                    dst = group_code[lease[1]]
                    if serving[i] != dst:
                        # stale route: forward to the leaseholder (one
                        # extra overlay hop), requeue at the new group
                        hstats["redirects"] += 1
                        self.hops[i] += 1
                        serving[i] = dst
                        prof = self._profile(
                            (dtypes[i], w, False, self.hops[i],
                             dst != self._l_client[i], self.n_of[dst]))
                        op_svc[i], op_post[i] = prof[1], prof[2]
                        if trace:
                            # the detour shifts the remaining boundaries;
                            # the fast engine pays it after ingress (the
                            # oracle before) — within the lease-run
                            # statistical contract, bit-free runs have
                            # no leases
                            b_lease[i] += dm.h_req[w]
                            b_ingr[i] = a + dm.h_req[w]
                        push(heap, (a + dm.h_req[w], pid, tau))
                        continue
                    if w:
                        lease[2] = True  # destination write supersedes src
                    elif not lease[2]:
                        # pull-on-demand: pay the transfer, complete this
                        # key's migration, then requeue the read
                        hstats["pulled"] += 1
                        hstats["released"] += 1
                        src_store = sim.groups[lease[0]]["state"] \
                            .stores[GLOBAL]
                        val = src_store.pop(op_key[i], None)
                        if val is not None:
                            stores[1][serving[i]][op_key[i]] = val
                        unavail.pop(op_key[i], None)
                        del leases[op_key[i]]
                        if trace:
                            b_lease[i] += pull_xfer
                            b_ingr[i] = a + pull_xfer
                        push(heap, (a + pull_xfer, pid, tau))
                        continue
            g = serving[i]
            # leader FIFO commit stage: the cumulative-max recurrence
            # dep = max(arrival, prev_departure) + service, online
            fs = free[g]
            start = a if a > fs else fs
            key = op_key[i]
            d = cache_d[g]
            if key in d:
                d.move_to_end(key)
                cache_hits[g] += 1
                svc = op_svc[i]  # + 0.0 penalty, exact
            else:
                cache_miss[g] += 1
                d[key] = True
                if len(d) > cache_cap[g]:
                    d.popitem(last=False)
                svc = op_svc[i] + seek
            dep = start + svc
            free[g] = dep
            busy[g] += svc
            dt = dtypes[i]
            if is_w[i]:
                if dt and live:
                    # defer the store mutation to the replicate instant
                    # (see the apply-event comment above the loop)
                    apply_key[tau] = key
                    apply_ki[tau] = l_key_idx[i]
                    apply_g[tau] = g
                    push(heap, (dep + op_post[i][0], pid, -2 - tau))
                elif dt and churn_events:
                    # the key may have been re-homed while in flight: the
                    # write follows the handoff (core-layer semantics)
                    ki = l_key_idx[i]
                    store = home_memo.get(ki)
                    if store is None:
                        kh = khash.get(ki)
                        if kh is None:
                            kh = khash[ki] = stable_hash(key)
                        owner_gid = sim.group_of_gateway[
                            sim.ring.locate_hash(kh)]
                        store = home_memo[ki] = \
                            sim.groups[owner_gid]["state"].stores[GLOBAL]
                    store[key] = _VAL
                    if unavail:
                        # fresh write at the live owner: available again
                        unavail.pop(key, None)
                else:
                    stores[dt][g][key] = _VAL
            elif dt and unavail and key in unavail:
                sim.lost_ops += 1  # read of a crashed, un-promoted key
            c = dep
            if trace:
                b_queue[i] = start
                b_svc[i] = dep
                post = op_post[i]
                c += post[0]                 # quorum / ReadIndex round
                b_repl[i] = c
                for comp in post[1:]:
                    c += comp
            else:
                for comp in op_post[i]:
                    c += comp
            latency[i] = c - t_start[i]
            completion[i] = c
            if c > max_completion:
                max_completion = c
            if live:
                to_flush.append(i)
            nxt = i + 1
            if nxt < thread_end[tau]:
                cursor[tau] = nxt
                push_op(nxt, tau, c)

        self._finish(max_completion)

    def _finish(self, max_completion: float) -> None:
        sim = self.sim
        sim.env.now = max(max_completion, self.last_time)
        for c, gid in enumerate(self.gid_of):
            g = sim.groups[gid]
            if self.busy[c]:
                g["leader"].busy_time += self.busy[c]
            g["page_cache"].hits += self.cache_hits[c]
            g["page_cache"].misses += self.cache_miss[c]
        if not self.n_ops:
            return
        if self.sim.live_stats:
            # incremental mode: earlier batches already flushed at aux
            # ticks; emit whatever completed after the last tick
            if self._to_flush:
                pend = self._to_flush
                self._to_flush = []
                self._emit(np.asarray(pend, dtype=np.int64))
            return
        comp = np.asarray(self.completion)
        # the oracle appends records at completion-event execution, i.e. in
        # (completion time, pid) order — reproduce it exactly
        order = np.lexsort((self.op_pid, comp))
        bounds = None
        if self.trace:
            # fill stages an op never entered forward from t_start
            # (vectorized fill_bounds), then append b_end = completion
            prev = np.asarray(self.t_start)
            bounds = []
            for col in self.b_cols:
                filled = np.asarray(col)
                nan = np.isnan(filled)
                if nan.any():
                    filled = np.where(nan, prev, filled)
                bounds.append(filled[order])
                prev = filled
            bounds.append(comp[order])
        sim.records.extend_columns(
            np.asarray(self.t_start)[order],
            np.asarray(self.latency)[order],
            self.kind[order], self.dtype[order],
            self.client_code[order],
            np.asarray(self.hops, dtype=np.int32)[order],
            bounds=bounds)


def plan_columns(plan: List[ThreadPlan], code_of_gid) -> dict:
    """Flat SoA schedule columns for a closed-loop plan, in (thread, op)
    order — the order that defines the heap engine's pid tie-breaks.

    Shared schedule extraction: the heap engine's :meth:`_FastEngine.
    load_plan` and the closed-loop sweep path (:mod:`repro_torch.sim.sweep`)
    both flatten plans through here, so a schedule-layout change cannot
    make the two engines drift.  ``code_of_gid`` maps a group id to its
    integer client code (``RecordArray.group_code`` for a live sim, the
    spawn index for the standalone sweep topology).
    """
    counts = [len(tp.key_idx) for tp in plan]
    bounds = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

    def concat(field, dt):
        if not plan:
            return np.empty(0, dt)
        return np.concatenate([getattr(tp, field) for tp in plan])

    client = (np.concatenate([np.full(c, code_of_gid(tp.gid), np.int32)
                              for c, tp in zip(counts, plan)])
              if plan else np.empty(0, np.int32))
    return dict(counts=counts, bounds=bounds, client=client,
                key_idx=concat("key_idx", np.int64),
                kind=concat("kind", np.uint8),
                dtype=concat("dtype", np.uint8),
                fwd=concat("fwd", bool))


def run_closed_loop_fast(sim: SimEdgeKV, plan: List[ThreadPlan]) -> None:
    eng = _FastEngine(sim)
    eng.load_plan(plan)
    eng.run()


# --------------------------------------------------- pure delay columns
def arrival_chain(xp, t0, c_req, f_req, sg_req, h_req, lf, glob, hops,
                  max_hops: int, cuts: Optional[list] = None):
    """Leader-arrival times from per-op delay-component columns.

    Masked sequential adds in the oracle's Timeout term order (float
    addition is not associative, so the order is part of the exactness
    contract).  Pure in ``xp`` — numpy for the per-run fast engine,
    torch inside the sweep's device program — so both paths evaluate
    bitwise the same float64 expression.

    ``cuts`` (tracing) collects the span-model stage boundaries as the
    chain passes them: ``b_request`` (client link, forward hop, gateway
    admit), ``b_route`` (after the overlay hops), ``b_ingress`` (after
    gw -> leader) — intermediate values of the SAME adds, so traced runs
    cost nothing extra and cannot drift from the untraced clock.
    """
    arr = t0 + c_req
    arr = xp.where(lf, arr + f_req, arr)
    arr = xp.where(glob, arr + sg_req, arr)
    if cuts is not None:
        cuts.append(arr)                 # b_request
    for k in range(max_hops):
        arr = xp.where(hops > k, arr + h_req, arr)
    if cuts is not None:
        cuts.append(arr)                 # b_route
    arr = xp.where(glob, arr + sg_req, arr)
    if cuts is not None:
        cuts.append(arr)                 # b_ingress
    return arr


def completion_chain(xp, dep, q_or_ri, sg_resp, g_resp, f_resp, c_resp,
                     lf, glob, remote, cuts: Optional[list] = None):
    """Completion times from leader departures: quorum/ReadIndex round,
    then the response hop chain (same masked-sequential-add contract as
    :func:`arrival_chain`).  ``cuts`` collects ``b_replicate`` (after the
    quorum/ReadIndex round) for tracing."""
    comp = dep + q_or_ri
    if cuts is not None:
        cuts.append(comp)                # b_replicate
    comp = xp.where(glob, comp + sg_resp, comp)
    comp = xp.where(remote, comp + g_resp, comp)
    comp = xp.where(glob, comp + sg_resp, comp)
    comp = xp.where(lf, comp + f_resp, comp)
    comp = comp + c_resp
    return comp


# ----------------------------------------------------- open-loop pieces
def _open_loop_segments(clients, rate: float, duration: float, now: float,
                        workload_kw: dict,
                        profiles: Optional[Dict[int, List[tuple]]] = None,
                        ) -> List[tuple]:
    """Per-client-group open-loop op schedules, identical draws for the
    fast engine and the sweep engine.

    ``clients`` rows are ``(group_code, gi, n, arrival_seed)``; returns
    ``(code, workload, t0, key_idx, kind, dtype, fwd)`` per group.
    ``profiles`` (scenario layer) maps a client *code* to piecewise-
    constant ``(t_start, t_end, factor)`` rate-multiplier segments
    relative to run start: each segment draws its own exponential stream
    at ``rate * factor`` (memoryless restart at segment boundaries,
    mirroring the oracle's per-segment clock).
    """
    segs = []
    for code, gi, n, aseed in clients:
        wl = YCSBWorkload(seed=2000 + gi, **workload_kw)
        if duration <= 0:
            continue
        rng = np.random.default_rng(np.random.SeedSequence(
            [(2000 + gi) & 0xFFFFFFFF, aseed]))
        profile = (profiles or {}).get(code)
        if profile is None:
            # arrival k fires iff arrival k-1 lands before t_end (oracle's
            # while-loop semantics), so one arrival may overshoot duration
            t = np.empty(0)
            chunk = max(64, int(rate * duration * 1.2) + 8)
            while t.size == 0 or t[-1] < duration:
                e = rng.exponential(1.0 / rate, size=chunk)
                t = np.concatenate(
                    [t, (t[-1] if t.size else 0.0) + np.cumsum(e)])
            count = int(np.searchsorted(t, duration, side="left")) + 1
            t0 = t[:count] + now  # arrivals start at current virtual time
        else:
            parts = []
            for s0, s1, factor in profile:
                if factor <= 0.0:
                    continue
                seg_len = s1 - s0
                r = rate * factor
                t = np.empty(0)
                chunk = max(64, int(r * seg_len * 1.2) + 8)
                while t.size == 0 or t[-1] < seg_len:
                    e = rng.exponential(1.0 / r, size=chunk)
                    t = np.concatenate(
                        [t, (t[-1] if t.size else 0.0) + np.cumsum(e)])
                parts.append(t[t < seg_len] + s0)
            t0 = (np.concatenate(parts) if parts else np.empty(0)) + now
            count = len(t0)
            if not count:
                continue
        key_idx, kind, dtype = wl.batch_ops(count, rng)
        fwd = ((dtype == LOCAL_CODE)
               & (rng.random(count) < (n - 1) / n))
        segs.append((code, wl, t0, key_idx, kind, dtype, fwd))
    return segs


def lru_hit_mask(key_seq: np.ndarray, capacity: int) -> np.ndarray:
    """Exact LRU hit/miss mask for an access sequence, without replaying
    the cache dict op by op.

    ``hit[i]`` iff ``key_seq[i]`` is resident in an LRU cache of
    ``capacity`` at access ``i`` (get-then-put semantics, as in
    :class:`repro_torch.core.cache.LRUCache`).  Classic LRU inclusion property:
    a re-access hits iff its stack distance — distinct keys touched since
    the previous access of the same key, counting itself — is at most the
    capacity.  When the whole sequence touches <= capacity distinct keys
    (the common sweep-grid case) no eviction can ever occur and the mask
    is simply "seen before" (pure numpy); otherwise stack distances come
    from one Fenwick pass over last-occurrence flags.
    """
    n = len(key_seq)
    if n == 0:
        return np.zeros(0, bool)
    order = np.argsort(key_seq, kind="stable")
    ks = key_seq[order]
    same = ks[1:] == ks[:-1]
    prev = np.full(n, -1, np.int64)
    prev[order[1:][same]] = order[:-1][same]
    first = prev < 0
    if int(first.sum()) <= capacity:
        return ~first

    tree = [0] * (n + 1)  # Fenwick over positions; 1 = last occurrence so far

    def add(i: int, v: int) -> None:
        i += 1
        while i <= n:
            tree[i] += v
            i += i & (-i)

    def prefix(i: int) -> int:  # sum over positions [0, i)
        s = 0
        while i > 0:
            s += tree[i]
            i -= i & (-i)
        return s

    hits = np.zeros(n, bool)
    plist = prev.tolist()
    for i in range(n):
        p = plist[i]
        if p >= 0:
            # distinct keys in (p, i) = active (last-occurrence) positions
            hits[i] = prefix(i) - prefix(p + 1) + 1 <= capacity
            add(p, -1)
        add(i, 1)
    return hits


def _replay_page_cache(grp: dict, keys: List[str], key_idx: np.ndarray,
                       is_w: np.ndarray, dtype: np.ndarray, seek: float,
                       apply_writes: bool) -> np.ndarray:
    """Per-group LRU replay in leader-arrival order: cold-page penalties,
    plus (optionally) applying committed writes to the group's real state
    machine exactly as the oracle does at commit time."""
    cache = grp["page_cache"]
    state = grp["state"]
    pens = np.zeros(len(key_idx))
    kil = key_idx.tolist()
    wrl = is_w.tolist()
    dtl = dtype.tolist()
    for j, ki in enumerate(kil):
        key = keys[ki]
        if cache.get(key) is None:
            pens[j] = seek
        cache.put(key, True)
        if apply_writes and wrl[j]:
            state.apply(("put",
                         GLOBAL if dtl[j] == GLOBAL_CODE else LOCAL,
                         key, _VAL))
    return pens


def _route_and_apply(sim: SimEdgeKV, idxs: np.ndarray, client: np.ndarray,
                     serving: np.ndarray, hops: np.ndarray,
                     key_idx: np.ndarray, keys: List[str],
                     is_w: np.ndarray, glob: np.ndarray,
                     dtype: np.ndarray,
                     pen: Optional[np.ndarray] = None,
                     refused: Optional[np.ndarray] = None) -> None:
    """Resolve routes and apply writes for one churn epoch's ops (already
    in schedule order) against the *current* ring membership — the
    open-loop analogue of the closed-loop engine's lazy ``_resolve``.
    ``pen`` collects per-op delay penalties (lease pull transfers) that
    feed into the arrival chain; ``refused`` (bool, len n_ops) marks ops
    a partition active during this epoch refuses — counted here,
    excluded from routing/write-apply/lease-pull, completed with the
    error-ack chain by the caller."""
    if not len(idxs):
        return
    if refused is not None and sim.partition_of:
        gids = sim.records._group_ids
        for i in idxs.tolist():
            cgid = gids[client[i]]
            if glob[i]:
                code = sim._refusal_code(cgid, keys[key_idx[i]],
                                         bool(is_w[i]))
            elif sim.partition_straddle and \
                    sim._group_side(cgid) is None:
                code = 2
            else:
                code = 0
            if code:
                refused[i] = True
                sim._count_refusal(cgid, bool(is_w[i]), code)
        idxs = idxs[~refused[idxs]]
        if not len(idxs):
            return
    ids = sim.records._group_ids
    gw_of_code = [sim.gateway_of_group[g] for g in ids]
    gsel = idxs[glob[idxs]]
    if len(gsel):
        if sim.gw_cache:
            gcode = sim.records.group_code
            for i in gsel.tolist():
                gw = gw_of_code[client[i]]
                key = keys[key_idx[i]]
                cache = sim.gw_cache[gw]
                cached = cache.get(key)
                if cached is not None:
                    owner_gw, h = cached, (0 if cached == gw else 1)
                else:
                    path = sim.ring.route(gw, key)
                    owner_gw, h = path[-1], len(path) - 1
                    cache.put(key, owner_gw)
                serving[i] = gcode(sim.group_of_gateway[owner_gw])
                hops[i] = h
        else:
            owner_code = {gw: sim.records._group_code[g]
                          for g, gw in sim.gateway_of_group.items()}
            owner, h = _batch_routes(sim.ring, gw_of_code, owner_code,
                                     client[gsel], key_idx[gsel], keys)
            serving[gsel] = owner
            hops[gsel] = h
    # writes land at the group that serves them under this epoch's
    # membership; later joins/drains migrate them (§7 handoff semantics)
    leases = sim.leases
    for i in idxs[is_w[idxs]].tolist():
        g = serving[i] if dtype[i] else client[i]
        tier = GLOBAL if dtype[i] else LOCAL
        key = keys[key_idx[i]]
        if leases and dtype[i]:
            lease = leases.get(key)
            if lease is not None:
                lease[2] = True  # destination write supersedes the source
        sim.groups[ids[g]]["state"].apply(("put", tier, key, _VAL))
    if sim.unavailable or leases:
        # fault/handoff window: walk this epoch's ops in schedule order —
        # a global write re-validates its key, a read of a still-pending
        # lease pulls it on demand (paying the transfer as an arrival
        # penalty), a global read of a still-unavailable key counts as
        # lost (oracle semantics, batched per membership epoch)
        unavail = sim.unavailable
        pull_xfer = sim.net.xfer("gw_gw", RECORD_BYTES + REQ_BYTES)
        for i in idxs.tolist():
            if not glob[i]:
                continue
            k = keys[key_idx[i]]
            if leases and not is_w[i]:
                lease = leases.get(k)
                if lease is not None and not lease[2]:
                    sim.handoff_stats["pulled"] += 1
                    sim.handoff_stats["released"] += 1
                    if pen is not None:
                        pen[i] += pull_xfer
                    src_store = sim.groups[lease[0]]["state"].stores[GLOBAL]
                    val = src_store.pop(k, None)
                    if val is not None:
                        sim.groups[lease[1]]["state"].stores[GLOBAL][k] = val
                    unavail.pop(k, None)
                    del leases[k]
                    continue
            if is_w[i]:
                unavail.pop(k, None)
            elif k in unavail:
                sim.lost_ops += 1


# --------------------------------------------------------------- open loop
def run_open_loop_fast(sim: SimEdgeKV, rate: float, duration: float,
                       workload_kw: dict,
                       client_groups: Optional[Tuple[str, ...]] = None,
                       rate_profiles: Optional[Dict[str, List[tuple]]]
                       = None,
                       ) -> None:
    """Fully batched open-loop run (Fig 13): exogenous Poisson arrivals
    mean there is no closed-loop feedback, so the leader stage resolves in
    one per-group pass — LRU replay for penalties, then the max-plus
    departure scan ``dep_i = max(arr_i, dep_{i-1}) + svc_i`` through
    :mod:`repro_torch.kernels.maxplus_scan`.

    Deferred auxiliary processes (churn drivers) are supported by
    *segmenting* the batch at membership events: ops are routed and their
    writes applied epoch by epoch against the then-current ring, while
    the departure scan still runs once per serving group over the whole
    run (the leader queue persists across epochs).
    """
    if sim.hot_keys or sim.track_hot or sim.live_stats:
        raise NotImplementedError(
            "hot-key mirrors / live stats need the per-op heap engine; "
            "use the closed-loop fast path")
    aux: Dict[int, Generator] = dict(sim.env.pending)
    sim.env.pending = []
    had_aux = bool(aux)
    dm = _DelayModel(sim.net, sim.service)
    gcode = sim.records.group_code

    clients = []
    prof_by_code: Dict[int, List[tuple]] = {}
    for gi, gid in enumerate(list(sim.groups)):
        if sim.groups[gid]["retired"]:
            continue
        if client_groups is not None and gid not in client_groups:
            continue
        sim.client_groups.add(gid)
        code = gcode(gid)
        clients.append((code, gi, sim.groups[gid]["n"],
                        sim._arrival_seed(gid)))
        profile = (rate_profiles or {}).get(gid)
        if profile is not None:
            prof_by_code[code] = profile
    segs = _open_loop_segments(clients, rate, duration, sim.env.now,
                               workload_kw, profiles=prof_by_code or None)
    if not segs and not aux:
        return

    keys = segs[0][1].keys if segs else []
    if segs:
        client = np.concatenate([np.full(len(s[2]), s[0], dtype=np.int32)
                                 for s in segs])
        t0 = np.concatenate([s[2] for s in segs])
        key_idx = np.concatenate([s[3] for s in segs])
        kind = np.concatenate([s[4] for s in segs])
        dtype = np.concatenate([s[5] for s in segs])
        fwd = np.concatenate([s[6] for s in segs])
    else:
        client = np.empty(0, np.int32)
        t0 = np.empty(0)
        key_idx = np.empty(0, np.int64)
        kind = dtype = np.empty(0, np.uint8)
        fwd = np.empty(0, bool)
    n_ops = len(t0)
    is_w = kind != READ_CODE
    glob = dtype == GLOBAL_CODE
    serving = client.copy()
    hops = np.zeros(n_ops, dtype=np.int32)

    pen = np.zeros(n_ops) if aux else None
    refused = (np.zeros(n_ops, bool)
               if (aux or sim.partition_of) else None)
    if aux:
        # membership-event segmentation: ops whose gateway *lookup* lands
        # before an aux event route (and commit writes) under the
        # membership in force at lookup time — t0 + cli->st (+ st->gw for
        # global data), mirroring where the oracle calls ring.route
        rt = t0 + np.where(is_w, dm.c_req[1], dm.c_req[0])
        rt = np.where(glob, rt + np.where(is_w, dm.sg_req[1],
                                          dm.sg_req[0]), rt)
        order_t = np.argsort(rt, kind="stable")
        t_sorted = rt[order_t]
        heap: List[tuple] = [(sim.env.now, pid) for pid in aux]
        heapq.heapify(heap)
        pos = 0
        while heap:
            te, pid = heapq.heappop(heap)
            end = int(np.searchsorted(t_sorted, te, side="left"))
            _route_and_apply(sim, order_t[pos:end], client, serving, hops,
                             key_idx, keys, is_w, glob, dtype, pen, refused)
            pos = end
            sim.env.now = te
            gen = aux[pid]
            try:
                ev = gen.send(None)
            except StopIteration:
                del aux[pid]
            else:
                if not isinstance(ev, Timeout):
                    raise TypeError("fast-engine auxiliary processes may "
                                    "only yield Timeout")
                heapq.heappush(heap, (te + ev.delay, pid))
        _route_and_apply(sim, order_t[pos:], client, serving, hops,
                         key_idx, keys, is_w, glob, dtype, pen, refused)
        if not n_ops:
            return
    elif refused is not None:
        # a partition installed before the run and never healed: one
        # whole-run epoch — refusal verdicts, routing, and write apply
        # all resolve against the (static) cut membership
        had_aux = True  # writes applied here, not in the LRU replay
        order_t = np.argsort(t0, kind="stable")
        _route_and_apply(sim, order_t, client, serving, hops,
                         key_idx, keys, is_w, glob, dtype, pen, refused)
    elif glob.any():
        # routing: one Chord route per unique (gateway, successor-vnode)
        # class; with a §7.2 location cache, consult/populate the
        # per-gateway caches in arrival order instead (hit/miss sequence
        # is order-dependent)
        ids = sim.records._group_ids
        gw_of_code = [sim.gateway_of_group[g] for g in ids]
        if sim.gw_cache:
            gsel = np.nonzero(glob)[0]
            for i in gsel[np.argsort(t0[gsel], kind="stable")].tolist():
                gw = gw_of_code[client[i]]
                key = keys[key_idx[i]]
                cache = sim.gw_cache[gw]
                cached = cache.get(key)
                if cached is not None:
                    owner_gw, h = cached, (0 if cached == gw else 1)
                else:
                    path = sim.ring.route(gw, key)
                    owner_gw, h = path[-1], len(path) - 1
                    cache.put(key, owner_gw)
                serving[i] = gcode(sim.group_of_gateway[owner_gw])
                hops[i] = h
        else:
            owner_code = {gw: sim.records._group_code[g]
                          for g, gw in sim.gateway_of_group.items()}
            owner, h = _batch_routes(sim.ring, gw_of_code, owner_code,
                                     client[glob], key_idx[glob], keys)
            serving[glob] = owner
            hops[glob] = h
    remote = glob & (serving != client)
    lf = (~glob) & fwd

    # per-op delay columns (masked sequential adds, oracle term order)
    def by_w(pair):
        return np.where(is_w, pair[1], pair[0])

    trace = sim.records.stages
    cuts: Optional[list] = [] if trace else None
    arr = arrival_chain(np, t0, by_w(dm.c_req), by_w(dm.f_req),
                        by_w(dm.sg_req), by_w(dm.h_req), lf, glob, hops,
                        int(hops.max()) if n_ops else 0, cuts=cuts)
    if pen is not None:
        # lease pull transfers delay the leader arrival of the reads that
        # completed a key's migration on demand (async handoff)
        arr = arr + pen
    if trace:
        b_request, b_route = cuts[0], cuts[1]
        # the pull transfer is the lease stage; with pen None the lease
        # boundary collapses onto b_route bitwise (zero-duration stage)
        b_lease = cuts[1] + pen if pen is not None else cuts[1]
        b_ingress = arr

    # leader stage: per-group LRU replay + max-plus departure scan in
    # arrival order (writes were already applied per epoch under churn).
    # Refused ops never reach a leader: no page-cache touch, no service.
    ids = sim.records._group_ids
    dep = np.zeros(n_ops)
    if trace:
        b_queue, b_service = np.zeros(n_ops), np.zeros(n_ops)
    svc_base = np.where(is_w, dm.svc_base[1], dm.svc_base[0])
    alive = ~refused if refused is not None else np.ones(n_ops, bool)
    for g in np.unique(serving[alive]).tolist():
        grp = sim.groups[ids[g]]
        sel = np.nonzero((serving == g) & alive)[0]
        order = sel[np.lexsort((sel, arr[sel]))]
        pens = _replay_page_cache(grp, keys, key_idx[order], is_w[order],
                                  dtype[order], dm.seek,
                                  apply_writes=not had_aux)
        svc = svc_base[order] + pens
        dep_g = maxplus_depart(arr[order], svc)
        dep[order] = dep_g
        if trace:
            # service start = max(arrival, previous departure); clamped to
            # the departure because the closed-form max-plus kernel may
            # differ from the sequential recurrence by ulps
            prev_dep = np.concatenate(([-np.inf], dep_g[:-1]))
            start = np.minimum(np.maximum(arr[order], prev_dep), dep_g)
            b_queue[order] = start
            b_service[order] = dep_g
        grp["leader"].busy_time += float(svc.sum())

    sizes = [sim.groups[g]["n"] for g in ids]
    q_by_code = np.asarray([dm.quorum(n) for n in sizes])
    ri_by_code = np.asarray([dm.readindex(n) for n in sizes])
    q_or_ri = np.where(is_w, q_by_code[serving], ri_by_code[serving])
    cuts2: Optional[list] = [] if trace else None
    comp = completion_chain(np, dep, q_or_ri, by_w(dm.sg_resp),
                            by_w(dm.g_resp), by_w(dm.f_resp),
                            by_w(dm.c_resp), lf, glob, remote, cuts=cuts2)
    if trace:
        b_replicate = cuts2[0]
    if refused is not None and refused.any():
        # refused ops complete with the error-ack chain instead: refusal
        # instant (client link, fwd hop, gateway lookup — wherever the
        # op was turned back) plus the header-only error hops home
        err_cli, err_f, err_sg = dm.c_req[0], dm.f_req[0], dm.sg_req[0]
        t_ref = t0 + by_w(dm.c_req)
        t_ref = np.where(lf, t_ref + by_w(dm.f_req), t_ref)
        t_ref = np.where(glob, t_ref + by_w(dm.sg_req), t_ref)
        comp_ref = np.where(glob, t_ref + err_sg,
                            np.where(lf, t_ref + err_f, t_ref)) + err_cli
        comp = np.where(refused, comp_ref, comp)
        hops = np.where(refused, 0, hops).astype(np.int32)
        if trace:
            # refused ops collapse every post-refusal stage onto the
            # refusal instant (b_request == t_ref bitwise by construction:
            # the arrival chain's first cut IS the same add sequence)
            for col in (b_route, b_lease, b_ingress, b_queue, b_service,
                        b_replicate):
                col[:] = np.where(refused, t_ref, col)

    order = np.lexsort((np.arange(n_ops), comp))
    bounds = None
    if trace:
        bounds = [b[order] for b in (b_request, b_route, b_lease, b_ingress,
                                     b_queue, b_service, b_replicate)]
        bounds.append(comp[order])
    sim.records.extend_columns(t0[order], (comp - t0)[order], kind[order],
                               dtype[order], client[order], hops[order],
                               bounds=bounds)
    sim.env.now = max(sim.env.now, float(comp.max()))

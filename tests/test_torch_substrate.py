"""The port's framework-free substrate (copied numpy/stdlib modules) must
agree exactly with the reference package: ring hashing and routing, YCSB
draws, closed-loop plans, the delay-column chains and the LRU mask."""
import numpy as np
import pytest

from repro.core.hashring import ChordRing as RefRing, stable_hash as ref_hash
from repro.sim import cluster as ref_cluster, vectorized as ref_vec
from repro.sim.ycsb import YCSBWorkload as RefWorkload
from repro_torch.core.hashring import ChordRing, stable_hash
from repro_torch.sim import cluster, vectorized
from repro_torch.sim.ycsb import YCSBWorkload


def _rings(n_gw, vnodes):
    rings = []
    for cls in (RefRing, ChordRing):
        ring = cls(virtual_nodes=vnodes)
        for i in range(n_gw):
            ring.add_node(f"gw{i}")
        rings.append(ring)
    return rings


def test_stable_hash_matches():
    keys = [f"user{i}" for i in range(2000)] + ["", "gw0", "é"]
    assert [stable_hash(k) for k in keys] == [ref_hash(k) for k in keys]


@pytest.mark.parametrize("n_gw,vnodes", [(5, 1), (17, 4)])
def test_ring_owners_and_routes_match(n_gw, vnodes):
    ref, port = _rings(n_gw, vnodes)
    keys = [f"user{i}" for i in range(10_000)]
    assert [port.locate(k) for k in keys] == [ref.locate(k) for k in keys]
    for i, k in enumerate(keys[:500]):
        start = f"gw{i % n_gw}"
        assert port.route(start, k) == ref.route(start, k)


@pytest.mark.parametrize("dist", ["uniform", "zipfian", "latest"])
def test_batch_ops_draws_match(dist):
    kw = dict(n_records=2_500, distribution=dist, p_global=0.3, seed=11)
    got = YCSBWorkload(**kw).batch_ops(5_000, np.random.default_rng(4))
    want = RefWorkload(**kw).batch_ops(5_000, np.random.default_rng(4))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_closed_loop_plan_draws_match():
    clients = [(gi, f"g{gi}", 3) for gi in range(4)]
    wkw = dict(p_global=0.5, distribution="zipfian", n_records=10_000)
    got = cluster.closed_loop_plan(clients, 8, 64, wkw, 3)
    want = ref_cluster.closed_loop_plan(clients, 8, 64, wkw, 3)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.gid == w.gid
        for f in ("key_idx", "kind", "dtype", "fwd"):
            assert np.array_equal(getattr(g, f), getattr(w, f)), f
    assert cluster.arrival_seed(5, "g3") == ref_cluster.arrival_seed(5, "g3")


def _columns(n, seed):
    rng = np.random.default_rng(seed)
    cols = {k: rng.random(n) * 1e-3 for k in
            ("t0", "c_req", "f_req", "sg_req", "h_req", "dep", "q_ri",
             "sg_resp", "g_resp", "f_resp", "c_resp")}
    cols.update(lf=rng.random(n) < 0.4, glob=rng.random(n) < 0.5,
                remote=rng.random(n) < 0.3,
                hops=rng.integers(0, 4, n).astype(np.int32))
    return cols


def test_delay_chains_bitwise_on_numpy():
    c = _columns(5_000, 7)
    for mod in (ref_vec, vectorized):
        cuts, ccuts = [], []
        arr = mod.arrival_chain(np, c["t0"], c["c_req"], c["f_req"],
                                c["sg_req"], c["h_req"], c["lf"], c["glob"],
                                c["hops"], 3, cuts=cuts)
        comp = mod.completion_chain(np, c["dep"], c["q_ri"], c["sg_resp"],
                                    c["g_resp"], c["f_resp"], c["c_resp"],
                                    c["lf"], c["glob"], c["remote"],
                                    cuts=ccuts)
        c[mod.__name__] = [arr, comp, *cuts, *ccuts]
    for g, w in zip(c[vectorized.__name__], c[ref_vec.__name__]):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("capacity,nkeys,n", [(8, 30, 400), (64, 50, 500),
                                              (2500, 100, 300), (5, 5, 100)])
def test_lru_hit_mask_matches(capacity, nkeys, n):
    seq = np.random.default_rng(capacity).integers(0, nkeys, size=n)
    assert np.array_equal(vectorized.lru_hit_mask(seq, capacity),
                          ref_vec.lru_hit_mask(seq, capacity))

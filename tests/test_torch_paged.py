"""The port's paged decode attention against the JAX reference on the
CPU: the plain versions the port runs there (the online softmax page by
page, and the gather oracle) against the reference's Pallas kernel in
interpret mode and its oracle, on the same numpy inputs; table entries
past a sequence's length, in range or not; empty sequences; and the
EdgeKV page pool feeding the port's paged attention."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.paged_attention import paged_attention as jax_paged
from repro_torch.core.hashring import ChordRing
from repro_torch.edgecache import PagePoolManager
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_online_ref,
                                                 paged_attention_ref,
                                                 paged_decode)

TOL = 2e-5   # the reference kernel tests' own (tests/test_kernels_paged.py)


def make_case(seed, B, H, K, hd, n_pages, page, P_max, max_len):
    """The reference tests' distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, hd)).astype(np.float32),
            rng.standard_normal((K, n_pages, page, hd)).astype(np.float32),
            rng.standard_normal((K, n_pages, page, hd)).astype(np.float32),
            rng.integers(0, n_pages, (B, P_max)).astype(np.int32),
            rng.integers(1, max_len + 1, (B,)).astype(np.int32))


def port(q, kp, vp, pt, ln):
    """The port's entry point (the online version on the CPU) and its gather
    oracle, as numpy."""
    t = [torch.from_numpy(np.asarray(a)) for a in (q, kp, vp, pt, ln)]
    got = paged_attention(*t).numpy()
    B, H, hd = q.shape
    K = kp.shape[0]
    oracle = paged_attention_ref(t[0].reshape(B, K, H // K, hd), *t[1:])
    return got, oracle.reshape(B, H, hd).numpy()


def reference(q, kp, vp, pt, ln, *, use_pallas):
    kw = dict(use_pallas=True, interpret=True) if use_pallas else dict(
        use_pallas=False)
    return np.asarray(jax_paged(*(jnp.asarray(a) for a in (q, kp, vp, pt,
                                                           ln)), **kw))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


# the three shapes of tests/test_kernels_paged.py, MQA included
@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["interpret", "oracle"])
@pytest.mark.parametrize("B,H,K,hd,page,P_max", [
    (2, 4, 2, 32, 8, 4),
    (3, 8, 8, 16, 16, 3),
    (1, 8, 1, 64, 8, 6),
])
def test_paged_matches_jax(B, H, K, hd, page, P_max, use_pallas):
    case = make_case(B * H + hd, B, H, K, hd, 16, page, P_max, page * P_max)
    want = reference(*case, use_pallas=use_pallas)
    got, oracle = port(*case)
    close(got, want)
    close(oracle, want)


def test_paged_shared_prefix_pages():
    """Two sequences sharing a global (deduplicated) prefix page see the
    same attention over it."""
    B, H, K, hd, page = 2, 2, 2, 16, 8
    rng = np.random.default_rng(1)
    q = np.repeat(rng.standard_normal((1, H, hd)).astype(np.float32), B, 0)
    kp = rng.standard_normal((K, 4, page, hd)).astype(np.float32)
    vp = rng.standard_normal((K, 4, page, hd)).astype(np.float32)
    pt = np.array([[2, 0], [2, 1]], np.int32)   # page 2: the shared prefix
    ln = np.array([page, page], np.int32)       # only the shared page valid
    got, oracle = port(q, kp, vp, pt, ln)
    close(got[0], got[1], 1e-6)
    close(oracle[0], oracle[1], 1e-6)
    close(got, reference(q, kp, vp, pt, ln, use_pallas=True))


def test_paged_ragged_lengths_ignore_garbage():
    """Entries past the length do not affect the output, whatever in-range
    slot they hold."""
    q, kp, vp, pt, _ = make_case(4, 1, 2, 2, 16, 8, 8, 4, 32)
    ln = np.array([11], np.int32)
    got1, oracle1 = port(q, kp, vp, pt, ln)
    pt2 = pt.copy()
    pt2[0, 2:] = 7                               # past ceil(11 / 8) = 2
    got2, oracle2 = port(q, kp, vp, pt2, ln)
    close(got1, got2, 1e-6)
    close(oracle1, oracle2, 1e-6)
    close(got1, reference(q, kp, vp, pt, ln, use_pallas=True))


def test_paged_out_of_range_garbage_past_length():
    """Entries past the length that are no pool slot at all (-1, N + 5):
    the port never dereferences them (a torch index would raise), and the
    output equals the in-range case's and the reference's."""
    n_pages = 8
    q, kp, vp, pt, _ = make_case(5, 2, 4, 2, 16, n_pages, 8, 4, 32)
    ln = np.array([11, 3], np.int32)
    pt_in = pt.copy()
    pt_in[0, 2:] = [3, 5]
    pt_in[1, 1:] = [7, 7, 7]
    pt_out = pt.copy()
    pt_out[0, 2:] = [-1, n_pages + 5]
    pt_out[1, 1:] = [n_pages + 5, -1, -1]
    got_in, oracle_in = port(q, kp, vp, pt_in, ln)
    got_out, oracle_out = port(q, kp, vp, pt_out, ln)
    close(got_out, got_in, 1e-6)
    close(oracle_out, oracle_in, 1e-6)
    for use_pallas in (True, False):
        close(got_out, reference(q, kp, vp, pt_out, ln, use_pallas=use_pallas))


def test_paged_empty_sequence_gives_zeros():
    q, kp, vp, pt, _ = make_case(6, 2, 4, 2, 16, 8, 8, 3, 24)
    ln = np.array([0, 13], np.int32)
    got, oracle = port(q, kp, vp, pt, ln)
    for out in (got, oracle):
        assert np.isfinite(out).all()
        assert not out[0].any()
    close(got, reference(q, kp, vp, pt, ln, use_pallas=True))
    close(got, reference(q, kp, vp, pt, ln, use_pallas=False))


@settings(max_examples=8, deadline=None)
@given(st.integers(1, 3), st.sampled_from([2, 4]), st.sampled_from([8, 16]))
def test_paged_property_random_shapes(B, K, page):
    H, hd, n_pages, P_max = K * 2, 16, 8, 3
    case = make_case(B * 7 + K + page, B, H, K, hd, n_pages, page, P_max,
                     page * P_max)
    got, oracle = port(*case)
    for use_pallas in (True, False):
        want = reference(*case, use_pallas=use_pallas)
        close(got, want)
        close(oracle, want)


def test_online_and_gather_versions_agree_at_gqa_width():
    """The port's two plain versions on one input at hd 128, G 4, page 12
    (not a power of two), lengths that end inside a page."""
    rng = np.random.default_rng(7)
    B, K, G, hd, N, page, P_max = 3, 2, 4, 128, 20, 12, 5
    q = torch.from_numpy(rng.standard_normal((B, K, G, hd)).astype(np.float32))
    kp, vp = (torch.from_numpy(rng.standard_normal((K, N, page, hd)).astype(
        np.float32)) for _ in range(2))
    pt = torch.from_numpy(rng.integers(0, N, (B, P_max)).astype(np.int32))
    ln = torch.tensor([1, 37, 60], dtype=torch.int32)
    close(paged_attention_online_ref(q, kp, vp, pt, ln),
          paged_attention_ref(q, kp, vp, pt, ln))


def test_scattered_pages_match_contiguous():
    """The port's copy of tests/test_paged_integration.py: the port's EdgeKV
    pool (a shared global prefix deduplicated, local pages per sequence)
    scattered through a pool and read by the port's paged attention equals
    the port's contiguous attention over each sequence's own KV."""
    B, H, K, hd = 2, 4, 2, 16
    page, n_ctx, n_slots = 8, 32, 64
    rng = np.random.default_rng(0)
    k_full = rng.standard_normal((B, K, n_ctx, hd)).astype(np.float32)
    v_full = rng.standard_normal((B, K, n_ctx, hd)).astype(np.float32)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)

    ring = ChordRing(virtual_nodes=4)
    for g in range(3):
        ring.add_node(f"g{g}")
    pool_mgr = PagePoolManager("g0", n_slots, page, ring)
    shared_tokens = np.arange(2 * page, dtype=np.int32)
    k_full[1, :, :2 * page] = k_full[0, :, :2 * page]
    v_full[1, :, :2 * page] = v_full[0, :, :2 * page]

    tables = []
    k_pool = np.zeros((K, n_slots, page, hd), np.float32)
    v_pool = np.zeros((K, n_slots, page, hd), np.float32)
    for b in range(B):
        refs = (pool_mgr.register_global(f"s{b}", shared_tokens)
                + pool_mgr.alloc_local(f"s{b}", 2))
        tables.append(pool_mgr.page_table(f"s{b}", max_pages=4))
        for i, r in enumerate(refs):
            k_pool[:, r.slot] = k_full[b, :, i * page:(i + 1) * page]
            v_pool[:, r.slot] = v_full[b, :, i * page:(i + 1) * page]
    assert tables[0][0] == tables[1][0] and tables[0][1] == tables[1][1]
    assert pool_mgr.used_slots == 2 + 2 * B

    page_table = np.stack(tables)
    lengths = np.full((B,), n_ctx, np.int32)
    out_paged, _ = port(q, k_pool, v_pool, page_table, lengths)
    # contiguous: the port's flash attention over each sequence's own KV
    out_flash = flash_attention(
        torch.from_numpy(q)[:, None], torch.from_numpy(k_full).transpose(1, 2),
        torch.from_numpy(v_full).transpose(1, 2), causal=False)[:, 0]
    close(out_paged, out_flash.numpy())
    # and a trivial pool where slot b holds sequence b's whole context
    out_trivial, _ = port(q, np.moveaxis(k_full, 1, 0),
                          np.moveaxis(v_full, 1, 0),
                          np.arange(B, dtype=np.int32)[:, None], lengths)
    close(out_paged, out_trivial)
    close(out_paged, reference(q, k_pool, v_pool, page_table, lengths,
                               use_pallas=True))


def test_paged_entry_point_rejects_what_the_kernel_cannot_fold():
    q = torch.zeros((1, 3, 16))
    pool = torch.zeros((2, 4, 8, 16))
    with pytest.raises(ValueError, match="multiple"):
        paged_attention(q, pool, pool, torch.zeros((1, 2), dtype=torch.int32),
                        torch.ones((1,), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode(q.reshape(1, 1, 3, 16), pool[:1], pool[:1],
                     torch.zeros((1, 2), dtype=torch.int32),
                     torch.ones((1,), dtype=torch.int32))

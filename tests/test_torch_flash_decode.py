"""The decode configuration of the port's flash kernel on the CPU: its key
split rule (``kernel.decode_splits``) and, against the JAX reference, the
split-and-merge arithmetic the CUDA kernel does (a plain-torch model of
it, here only): each warp of each CTA of a cluster runs the online
softmax over its keys of the CTA's share of the 64-key tiles in log2
units, then the warps' (m, l, acc) are merged, then the CTAs'.  The
kernel itself runs only on a GPU (``tests/test_torch_kernels_cuda.py``)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_kernel as jax_kernel
from repro.kernels.flash_attention import flash_attention_ref as jax_ref
from repro_torch.kernels.flash_attention import kernel as fk

TOL = 2e-5      # scaled by max(1, |ref|), the reference kernel tests' own
SMS = 132       # an H100 SXM's SMs
NEG_INF = -1e30
WARPS = 8       # warps of a decode CTA (flash_fwd.cu kDecWarps)
STEP = 8        # keys a warp takes a step (kStepKeys)


# (what, B * K, G Sq, Skv, splits): the serve paths' decode calls at 8
# requests over their 1056-slot caches (seamless-m4t-large-v2's
# cross-attention over 1024 frames), then edge shapes
SERVE_SHAPES = [
    ("seamless-m4t-large-v2 self", 8 * 16, 1, 1056, 1),
    ("seamless-m4t-large-v2 cross", 8 * 16, 1, 1024, 1),
    ("mixtral-8x7b", 8 * 8, 4, 1056, 2),
    ("stablelm-3b", 8 * 32, 1, 1056, 1),
    ("zamba2-1.2b", 8 * 32, 1, 1056, 1),
    ("granite-20b MQA", 8 * 1, 48, 1056, 2),
]
EDGE_SHAPES = [(1, 1, 1), (1, 1, 64), (1, 1, 65), (1, 4, 130),
               (3, 2, 1000), (200, 1, 1056), (66, 1, 1056),
               (67, 1, 1056), (66, 4, 1056), (67, 4, 1056),
               (10 ** 5, 1, 1056), (1, 1, 10 ** 6), (64, 1, 63),
               (1, 192, 1056), (8, 5, 1056)]


def check_rule(bk, rows, skv, n):
    tiles = -(-skv // fk.TILE)
    clusters = bk * (1 if rows <= 4 else -(-rows // 8))   # passes of rows
    assert 1 <= n <= fk.MAX_SPLIT
    assert n & (n - 1) == 0
    assert n <= tiles                        # at least one tile a split
    # within one CTA an SM, and the largest such
    assert n == 1 or clusters * n <= SMS
    assert 2 * n > fk.MAX_SPLIT or 2 * n > tiles or clusters * 2 * n > SMS


@pytest.mark.parametrize("what,bk,rows,skv,want", SERVE_SHAPES,
                         ids=[s[0] for s in SERVE_SHAPES])
def test_split_rule_at_the_serve_shapes(what, bk, rows, skv, want):
    n = fk.decode_splits(bk, rows, skv, SMS)
    check_rule(bk, rows, skv, n)
    assert n == want


@pytest.mark.parametrize("bk,rows,skv", EDGE_SHAPES)
def test_split_rule_at_edge_shapes(bk, rows, skv):
    check_rule(bk, rows, skv, fk.decode_splits(bk, rows, skv, SMS))


def test_split_count_ignores_kv_len(monkeypatch):
    """The wrapper hands the kernel the same splits whatever the valid
    length, a host int or a device int32 (the kernel's launch stubbed; the
    split count is the 15th argument)."""
    seen = []
    monkeypatch.setattr(fk, "_check", lambda *a: None)
    monkeypatch.setattr(fk, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(fk.cuda_build, "launch",
                        lambda name, fn, dev, *args: seen.append(args[14]))
    q = torch.zeros((8, 1, 32, 128))
    k = torch.zeros((8, 1056, 8, 128))
    for kv_len in (None, 0, 1, 64, 65, 1025, 1056,
                   torch.tensor(7, dtype=torch.int32)):
        fk.flash_fwd(q, k, k, causal=False, kv_len=kv_len)
    assert seen == [fk.decode_splits(64, 4, 1056, SMS)] * 8 == [2] * 8
    fk.flash_fwd(torch.zeros((8, 5, 32, 128)), k, k, causal=False)
    assert seen[-1] == 1     # prefill takes no splits


def merge(parts):
    """(m, l, acc) of the same rows over disjoint keys, at one max."""
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    return (M, sum(l * torch.exp2(m - M) for m, l, _ in parts),
            sum(a * torch.exp2(m - M) for m, _, a in parts))


def split_merge_decode(q, k, v, *, causal, window, seq_k, n_split):
    """What the decode configuration computes, in its order: q (B, Sq, H,
    hd) over k, v (B, Skv, K, hd) with ``seq_k`` valid keys.  Per (b, KV
    head) and pass of rows (row r = query r // G, head r % G; 4 rows a
    pass up to 4, else 8), split s of ``n_split`` takes tiles [s T / n,
    (s + 1) T / n) of the T 64-key tiles from lo; warp w of its CTA takes
    the split's keys 8 at a time, from the (8 w)-th on, every 64th, each
    step an online softmax in log2 units; the warps' (m, l, acc) are
    merged, then the splits'."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G, R = H // K, H // K * Sq
    rows = 4 if R <= 4 else 8
    sl2 = math.log2(math.e) / math.sqrt(hd)
    qr = q.reshape(B, Sq, K, G, hd).permute(0, 2, 1, 3, 4).reshape(
        B, K, R, hd)
    kh, vh = (t.permute(0, 2, 1, 3) for t in (k, v))   # (B, K, Skv, hd)
    out = torch.empty((B, K, R, hd))
    for row0 in range(0, R, rows):
        row1 = min(R, row0 + rows)
        qp = torch.arange(row0, row1) // G
        hi = min(seq_k, (row1 - 1) // G + 1) if causal else seq_k
        lo = max(0, row0 // G - window + 1) if window else 0
        ntiles = -(-(hi - lo) // fk.TILE) if hi > lo else 0
        splits = []
        for s in range(n_split):
            kfirst = lo + s * ntiles // n_split * fk.TILE
            kend = min(hi, lo + (s + 1) * ntiles // n_split * fk.TILE)
            warps = []
            for w in range(WARPS):
                m = torch.full((B, K, row1 - row0, 1), NEG_INF)
                l = torch.zeros_like(m)
                acc = torch.zeros((B, K, row1 - row0, hd))
                for k0 in range(kfirst + STEP * w, kend, STEP * WARPS):
                    keys = torch.arange(k0, min(k0 + STEP, kend))
                    mask = (keys[None] < seq_k) & (qp[:, None] < Sq)
                    if causal:
                        mask &= keys[None] <= qp[:, None]
                    if window:
                        mask &= keys[None] > qp[:, None] - window
                    sc = torch.einsum("bkrd,bktd->bkrt",
                                      qr[:, :, row0:row1],
                                      kh[:, :, keys]) * sl2
                    sc = torch.where(mask, sc, NEG_INF)
                    m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
                    p = torch.where(mask, torch.exp2(sc - m_new), 0.0)
                    corr = torch.exp2(m - m_new)
                    l = l * corr + p.sum(-1, keepdim=True)
                    acc = acc * corr + torch.einsum("bkrt,bktd->bkrd", p,
                                                    vh[:, :, keys])
                    m = m_new
                warps.append((m, l, acc))
            splits.append(merge(warps))
        _, L, A = merge(splits)
        out[:, :, row0:row1] = A / torch.clamp(L, min=1e-30)
    return out.reshape(B, K, Sq, G, hd).permute(0, 2, 1, 3, 4).reshape(
        B, Sq, H, hd)


def reference(q, k, v, *, causal, window, seq_k, interpret):
    """The JAX package's flash attention on the same inputs, heads folded
    and K/V repeated to the query heads: its Pallas kernel in interpret
    mode (padded to its blocks, the true lengths as its seq_q and seq_k),
    or its jnp oracle."""
    B, Sq, H, hd = q.shape
    G = H // k.shape[2]
    fold = lambda a, r: np.repeat(a.transpose(0, 2, 1, 3), r, axis=1
                                  ).reshape(-1, a.shape[1], hd)
    qf, kf, vf = fold(q, 1), fold(k, G), fold(v, G)
    if interpret:
        Skv, bk = kf.shape[1], 64
        kf, vf = (np.pad(a, ((0, 0), (0, -Skv % bk), (0, 0)))
                  for a in (kf, vf))
        got = jax_kernel(jnp.asarray(np.pad(qf, ((0, 0), (0, 8 - Sq),
                                                  (0, 0)))),
                         jnp.asarray(kf), jnp.asarray(vf), causal=causal,
                         window=window, block_q=8, block_k=bk, seq_q=Sq,
                         seq_k=seq_k, interpret=True)
        got = np.asarray(got)[:, :Sq]
    else:
        got = np.asarray(jax_ref(jnp.asarray(qf), jnp.asarray(kf),
                                 jnp.asarray(vf), causal=causal,
                                 window=window, seq_k=seq_k))
    return got.reshape(B, H, Sq, hd).transpose(0, 2, 1, 3)


# (B, Sq, Skv, H, K, hd, causal, window, seq_k, n_split): G 1, 4 and 48
# (MQA; its 48 to 192 rows take passes of 8), Sq 1 to 4 under causal
# and window masks; valid lengths so short that every split but one is
# empty (one tile), at a split boundary and one past it, and a cache whose
# slots are not a multiple of 64
CASES = [
    (2, 1, 200, 4, 4, 16, False, 0, 50, 8),
    (2, 1, 200, 4, 4, 16, False, 0, 1, 8),
    (2, 1, 300, 8, 2, 16, False, 0, 64, 8),
    (2, 1, 300, 8, 2, 16, False, 0, 65, 8),
    (2, 1, 300, 8, 2, 16, False, 0, 300, 4),
    (2, 2, 150, 8, 2, 8, True, 0, 150, 2),
    (1, 3, 150, 8, 2, 8, True, 2, 150, 8),
    (1, 4, 90, 8, 2, 8, False, 0, 70, 8),
    (1, 1, 200, 48, 1, 8, False, 0, 40, 8),
    (1, 1, 200, 48, 1, 8, False, 0, 200, 4),
    (1, 4, 130, 48, 1, 8, True, 3, 130, 8),
    (1, 2, 130, 48, 1, 8, False, 0, 129, 2),
]


@pytest.mark.parametrize("interpret", [True, False],
                         ids=["pallas_interpret", "jnp"])
@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,causal,window,seq_k,n_split",
                         CASES)
def test_split_merge_matches_the_reference(B, Sq, Skv, H, K, hd, causal,
                                           window, seq_k, n_split,
                                           interpret):
    rng = np.random.default_rng(Sq * 1000 + Skv + H + seq_k)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Sq, H, hd), (B, Skv, K, hd), (B, Skv, K, hd)))
    want = reference(q, k, v, causal=causal, window=window, seq_k=seq_k,
                     interpret=interpret)
    got = split_merge_decode(*(torch.from_numpy(a) for a in (q, k, v)),
                             causal=causal, window=window, seq_k=seq_k,
                             n_split=n_split).numpy()
    err = float(np.max(np.abs(got - want)))
    assert err <= TOL * max(1.0, float(np.max(np.abs(want)))), err


def test_split_merge_with_no_valid_key_gives_zeros():
    """A valid length of 0 (the kernel's device int32; the reference's 0
    means the whole cache) leaves every split empty: m = NEG_INF, l = 0,
    and the merge writes zeros, not nan."""
    q, k, v = (torch.from_numpy(np.random.default_rng(3).standard_normal(
        s).astype(np.float32)) for s in ((2, 1, 8, 16), (2, 100, 2, 16),
                                         (2, 100, 2, 16)))
    got = split_merge_decode(q, k, v, causal=False, window=0, seq_k=0,
                             n_split=2)
    assert torch.equal(got, torch.zeros_like(got))

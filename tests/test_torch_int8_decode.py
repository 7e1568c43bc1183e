"""K4's int8 decode instance on the CPU: the host rules that pick its
code copies' width (``kernel.decode_copy_bytes``) and its key splits
(``kernel.int8_decode_splits``), and ``flash_attention``
over an int8 K/V cache with its scales against the JAX reference's
``flash_attention_ref`` over the dequantized cache, at the shapes the GPU
tests give the ring (``tests/test_torch_kernels_cuda.py``).  The kernel
itself runs only on a GPU."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_ref as jax_ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import kernel as fk

TOL = 2e-5      # scaled by max(1, |ref|), the reference kernel tests' own
SMS = 132       # an H100 SXM's SMs


@pytest.mark.parametrize("offset", [0, 1, 2, 3, 4, 8, 12])
def test_copy_width_over_every_head_and_offset(offset):
    """16 bytes where that divides hd and both code addresses, else 4
    where that does, else 1, for hd 1..128 with K at 16-byte boundaries plus
    ``offset`` and V at one."""
    k_at, v_at = 4096 + offset, 8192
    for hd in range(1, fk.MAX_HD + 1):
        n = fk.decode_copy_bytes(hd, k_at, v_at)
        assert n in (1, 4, 16)
        assert hd % n == 0 and k_at % n == 0 and v_at % n == 0
        wider = [w for w in (4, 16) if w > n]
        assert all(hd % w or k_at % w for w in wider), (hd, n)
        assert hd // n <= 32 or n == 1     # a row in one pass of a warp


def test_copy_width_examples():
    aligned = (1 << 20, 1 << 21)
    assert [fk.decode_copy_bytes(hd, *aligned)
            for hd in (80, 64, 128, 72, 36, 100, 7, 1, 2, 6)] == [
        16, 16, 16, 4, 4, 4, 1, 1, 1, 1]
    assert fk.decode_copy_bytes(80, (1 << 20) + 4, 1 << 20) == 4
    assert fk.decode_copy_bytes(80, 1 << 20, (1 << 20) + 8) == 4
    assert fk.decode_copy_bytes(80, (1 << 20) + 1, 1 << 20) == 1
    assert fk.decode_copy_bytes(128) == 16   # no address: hd alone


# (what, B K, G Sq, Skv, splits): chip_smoke.py's INT8_FLASH shapes, 8
# requests over 1056 slots
SERVE_SHAPES = [("stablelm-3b", 8 * 32, 1, 1056, 1),
                ("seamless-m4t-large-v2 decoder self", 8 * 16, 1, 1056, 2),
                ("mixtral-8x7b", 8 * 8, 4, 1056, 2),
                ("granite-20b MQA", 8 * 1, 48, 1056, 2)]
EDGE = [(bk, rows, skv) for bk in (1, 3, 8, 64, 65, 66, 67, 128, 132, 133,
                                   256, 10 ** 5)
        for rows in (1, 2, 4, 5, 8, 48, 192) for skv in (1, 63, 64, 65, 300,
                                                         1056, 10 ** 6)]


@pytest.mark.parametrize("what,bk,rows,skv,want", SERVE_SHAPES,
                         ids=[s[0] for s in SERVE_SHAPES])
def test_int8_split_rule_at_the_serve_shapes(what, bk, rows, skv, want):
    assert fk.int8_decode_splits(bk, rows, skv, SMS) == want


def test_int8_split_rule_over_edge_shapes():
    """1 to 8 splits, a power of two, at least one 64-key tile a split;
    the float instance's rule at more than one row; at one row within
    two CTAs an SM and the largest such.  The rule takes the cache's
    size, not the valid length, so one call serves any kv_len."""
    assert list(inspect.signature(fk.int8_decode_splits).parameters) == [
        "bk", "rows", "skv", "sms"]
    for bk, rows, skv in EDGE:
        n = fk.int8_decode_splits(bk, rows, skv, SMS)
        tiles = -(-skv // fk.TILE)
        assert 1 <= n <= fk.MAX_SPLIT and n & (n - 1) == 0
        assert n <= tiles
        if rows > 1:
            assert n == fk.decode_splits(bk, rows, skv, SMS)
            continue
        assert n >= fk.decode_splits(bk, rows, skv, SMS)
        assert n == 1 or bk * n <= 2 * SMS
        assert (2 * n > fk.MAX_SPLIT or 2 * n > tiles
                or bk * 2 * n > 2 * SMS)


# (B, Sq, Skv, H, K, hd, causal, window, kv_len): the GPU tests' new int8
# cases (copies of 4 and 8 bytes and of one, a round's and a ring's edge)
CASES = [
    (2, 1, 1000, 8, 2, 7, False, 0, 513),
    (2, 1, 1000, 8, 2, 36, False, 0, 513),
    (2, 2, 300, 16, 4, 72, True, 0, None),
    (2, 1, 1000, 8, 2, 100, False, 0, 777),
    (1, 4, 300, 48, 1, 100, True, 5, None),
    (4, 1, 300, 32, 32, 80, False, 0, 63),
    (4, 1, 300, 32, 32, 80, False, 0, 64),
    (4, 1, 300, 32, 32, 80, False, 0, 65),
    (4, 1, 300, 32, 32, 80, False, 0, 255),
    (4, 1, 300, 32, 32, 80, False, 0, 256),
    (4, 1, 300, 32, 32, 80, False, 0, 257),
]


@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,causal,window,kv_len", CASES)
def test_int8_flash_attention_vs_reference(B, Sq, Skv, H, K, hd, causal,
                                           window, kv_len):
    rng = np.random.default_rng(Sq * hd + Skv + (kv_len or 0))
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k8, v8 = (rng.integers(-127, 128, (B, Skv, K, hd)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(1e-3, 0.05, (B, Skv, K, 1)).astype(np.float32)
              for _ in range(2))
    n = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k8),
                          torch.from_numpy(v8), causal=causal,
                          window=window, kv_len=n,
                          kv_scales=(torch.from_numpy(ks),
                                     torch.from_numpy(vs))).numpy()
    # the reference's layout: (B H, S, hd), each query head over its KV
    # head's dequantized rows, k_cache.astype(f32) * ksc
    G = H // K

    def fold(x, reps=1):
        x = np.repeat(x, reps, axis=2)
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(
            -1, x.shape[1], x.shape[3]))

    want = np.asarray(jax_ref(
        fold(q), fold(k8.astype(np.float32) * ks, G),
        fold(v8.astype(np.float32) * vs, G), causal=causal, window=window,
        seq_k=kv_len or 0)).reshape(B, H, Sq, hd).transpose(0, 2, 1, 3)
    err = float(np.abs(got - want).max())
    assert err <= TOL * max(1.0, float(np.abs(want).max())), err

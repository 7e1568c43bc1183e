"""The port's CUDA kernels and its sweep on the GPU, against their plain
PyTorch versions on the same inputs.  Every test needs a GPU and skips
without one; run them on a GPU host with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

This file imports neither jax nor the reference package, so it runs on a
host that has only torch and numpy."""
from dataclasses import asdict

import numpy as np
import pytest
import torch

from repro_torch.kernels.maxplus_scan import kernel as mp_kernel
from repro_torch.kernels.maxplus_scan import (maxplus_chunked,
                                              maxplus_chunked_ref,
                                              maxplus_depart,
                                              maxplus_depart_ref,
                                              maxplus_seq)
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref,
                                                 flash_fwd)
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_online_ref,
                                                 paged_attention_ref,
                                                 paged_decode)
from repro_torch.kernels.ssm_scan import (ssd_chunked_ref, ssd_ref, ssm_scan,
                                          ssm_scan_kernel)
from repro_torch.launch.serve import serve
from repro_torch.models import attention as tattn
from repro_torch.models import init_params
from repro_torch.sim.sweep import closed_grid, run_sweep, sweep_grid

pytestmark = pytest.mark.cuda


def make(R, L, seed, dtype):
    rng = np.random.default_rng(seed)
    a = np.sort(rng.random((R, L)), axis=-1) * 10
    s = rng.random((R, L)) * 0.3
    return (torch.from_numpy(a).to(dtype), torch.from_numpy(s).to(dtype))


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("R,L", [(1, 1), (5, 37), (33, 1000)])
def test_chunked_kernel_vs_plain(cuda_device, monkeypatch, dtype, rtol, R,
                                 L):
    a, s = make(R, L, R * L, dtype)
    init = torch.linspace(0.0, 8.0, R, dtype=dtype)
    for x0 in (None, init):
        want = maxplus_chunked_ref(a, s, x0)
        got = maxplus_chunked(a.to(cuda_device), s.to(cuda_device),
                              None if x0 is None else x0.to(cuda_device))
        torch.testing.assert_close(got.cpu(), want, rtol=rtol, atol=rtol)
    # the rows per CTA must be bit-invisible
    a, s = a.to(cuda_device), s.to(cuda_device)
    many = maxplus_chunked(a, s)
    monkeypatch.setattr(mp_kernel, "WARPS_PER_CTA", 1)
    assert torch.equal(maxplus_chunked(a, s), many)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("R,L", [(1, 1), (5, 37), (33, 1000)])
def test_seq_kernel_bitwise_vs_plain(cuda_device, dtype, R, L):
    a, s = make(R, L, R + 7 * L, dtype)
    reset = torch.zeros((R, L), dtype=torch.bool)
    reset[:, L // 2] = True
    init = torch.linspace(0.0, 8.0, R, dtype=dtype)
    for kw in ({}, {"reset": reset}, {"init": init}):
        want = maxplus_depart_ref(a, s, **kw)
        got = maxplus_seq(a.to(cuda_device), s.to(cuda_device),
                          **{k: v.to(cuda_device) for k, v in kw.items()})
        assert torch.equal(got.cpu(), want)


# rows of odd length (float64 rows then start off a 16-byte boundary, and
# reset rows off a 4-byte one) and more rows than the card has SMs
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("R,L", [(300, 1001), (1000, 8155)])
def test_seq_kernel_bitwise_on_unaligned_rows(cuda_device, dtype, R, L):
    a, s = make(R, L, R + L, dtype)
    reset = torch.zeros((R, L), dtype=torch.bool)
    reset[:, L // 3] = True
    reset[::7, 5] = True
    init = torch.linspace(0.0, 8.0, R, dtype=dtype)
    for kw in ({}, {"reset": reset}, {"init": init}):
        want = maxplus_depart_ref(a, s, **kw)
        got = maxplus_seq(a.to(cuda_device), s.to(cuda_device),
                          **{k: v.to(cuda_device) for k, v in kw.items()})
        assert torch.equal(got.cpu(), want)


# the rows a CTA owns come from R and the SM count (132 on an H100: one
# row a CTA up to 132 rows, two at 133); they must not change a bit
@pytest.mark.parametrize("R", [1, 131, 132, 133])
def test_seq_kernel_rows_per_cta_is_bit_invisible(cuda_device, R):
    L = 700
    a, s = make(R, L, 3 * R, torch.float64)
    reset = torch.zeros((R, L), dtype=torch.bool)
    reset[:, 250] = True
    init = torch.linspace(0.0, 8.0, R, dtype=torch.float64)
    for kw in ({}, {"reset": reset}, {"init": init}):
        kw = {k: v.to(cuda_device) for k, v in kw.items()}
        a_d, s_d = a.to(cuda_device), s.to(cuda_device)
        together = maxplus_seq(a_d, s_d, **kw)
        for r in range(R):
            one = {k: v[r:r + 1].contiguous() for k, v in kw.items()}
            alone = maxplus_seq(a_d[r:r + 1].contiguous(),
                                s_d[r:r + 1].contiguous(), **one)
            assert torch.equal(alone, together[r:r + 1]), r


def test_wrappers_count_and_reject(cuda_device):
    a, s = make(4, 64, 0, torch.float64)
    a, s = a.to(cuda_device), s.to(cuda_device)
    before = (maxplus_chunked.launches, maxplus_seq.launches)
    maxplus_depart(a, s, backend="cuda")
    maxplus_depart(a, s, backend="ref")
    assert (maxplus_chunked.launches, maxplus_seq.launches) == (
        before[0] + 1, before[1] + 1)
    with pytest.raises(ValueError):
        maxplus_seq(a[:, ::2], s[:, ::2])          # not contiguous
    with pytest.raises(TypeError):
        maxplus_chunked(a.half(), s.half())
    with pytest.raises(ValueError):
        maxplus_chunked(a, s.cpu())


def _assert_columns_match(got, want, rtol):
    for name, w in want.columns.items():
        g = got.columns[name]
        assert np.array_equal(np.isnan(g), np.isnan(w)), name
        ok = ~np.isnan(w)
        assert np.all(np.abs(g[ok] - w[ok])
                      <= rtol * np.maximum(1.0, np.abs(w[ok]))), name


def test_sweep_on_gpu_matches_cpu(cuda_device):
    grid = sweep_grid()[::16]
    _assert_columns_match(run_sweep(grid, device=cuda_device),
                          run_sweep(grid, device="cpu"), 1e-9)
    pts = closed_grid(threads=4, ops=40)[:4]
    got = run_sweep(pts, loop="closed", device=cuda_device)
    want = run_sweep(pts, loop="closed", device="cpu")
    # the sequential kernel is bitwise, so the fixed points are identical
    _assert_columns_match(got, want, 0.0)
    assert got.info["rounds"] == want.info["rounds"]
    assert [asdict(p) for p in got.points] == [asdict(p) for p in pts]


def ssd_inputs(BH, S, P, N, seed, decay=None):
    """The reference kernel tests' distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BH, S, P))
    loga = (-np.logaddexp(0.0, rng.standard_normal((BH, S, 1)))
            if decay is None else np.full((BH, S, 1), decay))
    dt = 1.0 / (1.0 + np.exp(-rng.standard_normal((BH, S, 1))))
    Bm = rng.standard_normal((BH, S, N)) / np.sqrt(N)
    Cm = rng.standard_normal((BH, S, N)) / np.sqrt(N)
    h0 = rng.standard_normal((BH, N, P))
    return [torch.from_numpy(a).float() for a in (x, loga, dt, Bm, Cm, h0)]


def assert_scaled_close(got, want, tol):
    """max |got - want| <= tol * max(1, max |want|)."""
    err = float((got.cpu() - want).abs().max())
    assert err <= tol * max(1.0, float(want.abs().max())), err


# the reference kernel tests' four cases, mLSTM's numerator and
# denominator scans, and widths that end inside a tile; then one chunk
# (S = chunk), 128 chunks for the pass, one row, the P = 1 path at N 384,
# 45 and 600 (two groups of a thread's state rows), P 70 and N 45 inside
# every 128-wide tile, an odd P (single stores, a scalar pass), the
# one-request serve shape, more than 65535 (row, chunk) pairs and
# zamba2-1.2b's Mamba2 scan (8 requests x 64 heads, N = P = 64)
@pytest.mark.parametrize("BH,S,chunk,P,N", [
    (3, 32, 8, 16, 8), (3, 64, 16, 8, 16), (3, 16, 16, 32, 8),
    (3, 48, 8, 16, 16), (8, 256, 128, 384, 384), (8, 256, 128, 1, 384),
    (2, 40, 20, 70, 45), (4, 128, 128, 384, 384), (2, 1024, 8, 64, 48),
    (1, 256, 128, 384, 384), (2, 1024, 128, 1, 384), (3, 256, 64, 1, 45),
    (2, 256, 128, 1, 600), (2, 256, 128, 70, 45), (2, 96, 32, 3, 45),
    (4, 1024, 128, 384, 384), (520, 128, 1, 3, 8), (520, 128, 1, 1, 8),
    (512, 256, 128, 64, 64)])
def test_ssd_kernel_vs_plain(cuda_device, BH, S, chunk, P, N):
    x, loga, dt, Bm, Cm, h0 = ssd_inputs(BH, S, P, N, S * P + N)
    for state in (None, h0):
        want_y, want_h = ssd_chunked_ref(x, loga, dt, Bm, Cm, chunk=chunk,
                                         h0=state)
        got_y, got_h = ssm_scan(
            *(t.to(cuda_device) for t in (x, loga, dt, Bm, Cm)),
            chunk=chunk, h0=None if state is None else state.to(cuda_device))
        assert_scaled_close(got_y, want_y, 1e-4)
        assert_scaled_close(got_h, want_h, 1e-4)
    if S <= 64:   # and the sequential oracle
        assert_scaled_close(got_y, ssd_ref(x, loga, dt, Bm, Cm, h0)[0], 1e-4)


def test_ssd_kernel_strong_decay_stays_finite(cuda_device):
    """60 nats a token: above the diagonal exp(cum_t - cum_s) is inf, so a
    kernel that multiplied by the mask would give nan."""
    x, loga, dt, Bm, Cm, _ = ssd_inputs(4, 256, 64, 32, 5, decay=-60.0)
    got_y, got_h = ssm_scan(*(t.to(cuda_device)
                              for t in (x, loga, dt, Bm, Cm)), chunk=128)
    assert torch.isfinite(got_y).all() and torch.isfinite(got_h).all()
    want = torch.einsum("bsd,bsd,bsp->bsp", Cm, Bm, x * dt)
    assert_scaled_close(got_y, want, 1e-4)


@pytest.mark.parametrize("P", [384, 1, 64])
def test_ssd_kernel_is_float32_accurate(cuda_device, P):
    """The 3xTF32 products (and, at P = 1, the recurrence) keep float32
    accuracy: against a float64 run of the plain version, y and the final
    state at most 8x as far as the plain float32 version on the CPU.  One
    TF32 pass keeps 10 mantissa bits and lands hundreds of times as
    far."""
    x, loga, dt, Bm, Cm, h0 = ssd_inputs(2, 512, P, 384, 19)
    args = (x, loga, dt, Bm, Cm)
    want = ssd_chunked_ref(*(t.double() for t in args), chunk=128,
                           h0=h0.double())
    plain = ssd_chunked_ref(*args, chunk=128, h0=h0)
    got = ssm_scan(*(t.to(cuda_device) for t in args), chunk=128,
                   h0=h0.to(cuda_device))
    for what, g, p, w in zip(("y", "h_final"), got, plain, want):
        err_plain = float((p.double() - w).abs().max())
        err = float((g.cpu().double() - w).abs().max())
        assert err <= 8 * err_plain, (what, err, err_plain)


def test_ssd_wrapper_counts_and_rejects(cuda_device):
    x, loga, dt, Bm, Cm, h0 = (t.to(cuda_device)
                               for t in ssd_inputs(2, 32, 8, 8, 1))
    ones = torch.ones_like(x[..., :1])
    # one call, one count, however many CUDA launches it makes
    for args, kw in (((x, loga, dt, Bm, Cm), {}),
                     ((x, loga, dt, Bm, Cm), {"h0": h0}),
                     ((ones, loga, dt, Bm, Cm), {})):
        before = ssm_scan_kernel.launches
        ssm_scan(*args, chunk=8, **kw)
        assert ssm_scan_kernel.launches == before + 1
    with pytest.raises(TypeError):
        ssm_scan_kernel(x.double(), loga, dt, Bm, Cm, chunk=8)
    with pytest.raises(ValueError):
        ssm_scan_kernel(x[:, :, ::2], loga, dt, Bm, Cm, chunk=8)
    with pytest.raises(ValueError):
        ssm_scan_kernel(x, loga, dt, Bm, Cm, chunk=12)   # does not divide
    with pytest.raises(ValueError):
        ssm_scan_kernel(x, loga, dt, Bm, Cm.cpu(), chunk=8)


def serve_on_both(arch, cuda_device, **kw):
    """``arch`` (reduced) served on the card with weights drawn there,
    then on the CPU with the card's weights, fed the card's tokens."""
    model = init_params(reduced(get_config(arch)), kw["seed"],
                        device=cuda_device)
    gpu = serve(device=cuda_device, params=model, **kw)
    cpu = serve(device="cpu", params=model.cpu(),
                teacher_tokens=gpu["tokens"], **kw)
    assert gpu["pool"] == cpu["pool"]
    err = np.abs(gpu["logits"] - cpu["logits"]).max()
    assert err <= 1e-4 * max(1.0, np.abs(cpu["logits"]).max()), err
    return gpu


def test_serve_on_gpu_matches_cpu(cuda_device):
    """reduced xlstm-125m served on the card, then on the CPU fed the
    card's tokens: the same logits (scaled 1e-4), and the prefill went
    through the kernel (numerator + denominator per mLSTM layer)."""
    before = ssm_scan_kernel.launches
    gpu = serve_on_both("xlstm-125m", cuda_device, requests=3,
                        prompt_len=48, gen_len=4, shared_prefix_len=16,
                        seed=1)
    assert ssm_scan_kernel.launches - before == 2 * 2   # 2 mLSTM layers
    assert gpu["launches"]["ssd_chunked"] == {"prefill": 4, "decode": 0}


def flash_inputs(B, Sq, Skv, H, K, hd, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for shape in ((B, Sq, H, hd), (B, Skv, K, hd), (B, Skv, K, hd))]


# (B, Sq, Skv, H, K, hd, causal, window, kv_len): the serve path's head
# (hd 80), the reference kernel tests' cases (GQA, MQA, ragged 33,
# windows), hd 128 and a width that ends inside a thread's columns; the
# one-query (decode) configuration with a true length, and two queries
# with causal and window masks through it.  Then the tile configuration
# at heads that are not a multiple of 8 (zero-filled to one: 36, 100, and
# 7, which is not a multiple of 4 either and is staged by 4-byte copies),
# one row of the serve shape (S 1024: 16 KV tiles, heaviest first), and
# Sq 5, the fewest queries that take the tile configuration; last
# zamba2-1.2b's shared block (heads of 64): a row of its prefill and its
# decode over the cache's valid prefix
@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,causal,window,kv_len", [
    (2, 200, 200, 4, 4, 80, True, 0, None),
    (2, 64, 64, 4, 2, 64, True, 0, None),
    (2, 96, 96, 8, 1, 64, True, 0, None),
    (2, 33, 33, 4, 4, 32, True, 0, None),
    (2, 128, 128, 2, 2, 16, True, 0, None),
    (1, 130, 130, 4, 2, 32, True, 8, None),
    (1, 130, 130, 4, 2, 32, True, 17, None),
    (1, 130, 130, 4, 2, 32, True, 64, None),
    (2, 48, 48, 4, 4, 32, False, 0, None),
    (1, 70, 70, 2, 2, 128, True, 0, None),
    (1, 70, 90, 3, 3, 72, False, 0, 77),
    (4, 1, 1056, 8, 8, 80, False, 0, 1025),
    (2, 1, 300, 4, 2, 16, False, 0, 1),
    (2, 3, 40, 4, 2, 80, True, 2, None),
    (2, 100, 100, 4, 2, 36, True, 0, None),
    (1, 150, 150, 2, 2, 100, True, 0, None),
    (1, 90, 90, 2, 1, 100, False, 0, 77),
    (2, 40, 40, 2, 1, 7, True, 5, None),
    (1, 1024, 1024, 2, 2, 80, True, 0, None),
    (2, 5, 5, 4, 2, 80, True, 0, None),
    (2, 5, 70, 4, 4, 80, False, 0, 66),
    (1, 1024, 1024, 2, 2, 64, True, 0, None),
    (4, 1, 1056, 8, 8, 64, False, 0, 1025),
])
def test_flash_kernel_vs_plain(cuda_device, B, Sq, Skv, H, K, hd, causal,
                               window, kv_len):
    q, k, v = flash_inputs(B, Sq, Skv, H, K, hd, Sq * hd + Skv)
    kw = dict(causal=causal, window=window)
    want = flash_attention(q, k, v, kv_len=kv_len, **kw)
    lens = [kv_len] if kv_len is None else [
        kv_len, torch.tensor(kv_len, dtype=torch.int32, device=cuda_device)]
    for n in lens:   # a host int, or the decode cache's device int32
        got = flash_attention(q.to(cuda_device), k.to(cuda_device),
                              v.to(cuda_device), kv_len=n, **kw)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=2e-5)
    # and the naive oracle, heads folded
    G = H // K
    fold = lambda t, r: t.transpose(1, 2).repeat_interleave(r, 1).reshape(
        -1, t.shape[1], hd)
    naive = flash_attention_ref(fold(q, 1), fold(k, G), fold(v, G),
                                seq_k=kv_len or 0, **kw)
    torch.testing.assert_close(
        got.cpu(), naive.reshape(B, H, Sq, hd).transpose(1, 2), rtol=2e-5,
        atol=2e-5)


def test_flash_tile_is_float32_accurate(cuda_device):
    """The tile configuration's 3xTF32 products keep float32 accuracy:
    against a float64 oracle, at most 8x as far as the plain float32
    version, which leaves room for the split's remainder, ex2.approx
    and the online softmax's rescales; one TF32 pass, emulated, lands
    about 2000x as far.  The seed and inputs of the CPU emulation of the
    scheme, test_torch_attention.py::test_3xtf32_split_meets_flash_tol:
    stablelm-3b's head width, causal, S 256."""
    rng = np.random.default_rng(17)
    S, hd = 256, 80
    q, k, v = (rng.standard_normal((S, hd)).astype(np.float32)
               for _ in range(3))
    causal = np.tril(np.ones((S, S), bool))
    s64 = (q.astype(np.float64) @ k.T.astype(np.float64)) * hd ** -0.5
    s64 = np.where(causal, s64, -np.inf)
    p64 = np.exp(s64 - s64.max(axis=1, keepdims=True))
    want = (p64 @ v.astype(np.float64)) / p64.sum(axis=1, keepdims=True)
    qkv = [torch.from_numpy(x)[None, :, None, :] for x in (q, k, v)]
    plain = flash_attention(*qkv, causal=True)[0, :, 0]
    got = flash_attention(*(t.to(cuda_device) for t in qkv),
                          causal=True)[0, :, 0].cpu()
    err_plain = float(np.abs(plain.double().numpy() - want).max())
    err = float(np.abs(got.double().numpy() - want).max())
    assert err <= 8 * err_plain, (err, err_plain)


def attention64(q, k, v, causal, window):
    """Softmax attention in float64 over K/V repeated to the query heads,
    the hidden keys selected away: the gradients' oracle (autograd)."""
    from repro_torch.kernels.flash_attention.ref import _mask
    G = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(G, 2), v.repeat_interleave(G, 2)
    S = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
    mask = _mask(S, torch.arange(S), causal=causal, window=window,
                 seq_q=S, seq_k=S)
    p = torch.softmax(torch.where(mask, s, -torch.inf), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", torch.where(mask, p, 0.0), v)


@pytest.mark.parametrize("H,K,hd,causal,window", [
    (4, 4, 80, True, 0),        # stablelm-3b's heads
    (8, 2, 128, True, 64),      # mixtral-8x7b's GQA under a window
    (4, 1, 128, False, 0)])     # MQA, bidirectional
def test_flash_gradient_is_float32_accurate(cuda_device, H, K, hd, causal,
                                            window):
    """FlashAttention's dq, dk and dv on the card (the forward K4, the
    backward in torch ops from K4's output) against float64 autograd of
    plain attention: within 8x the plain float32 version's error on the
    CPU, as test_flash_tile_is_float32_accurate holds the forward.  The
    forward launches K4 once; the backward launches no kernel of ours."""
    rng = np.random.default_rng(23)
    B, S = 2, 256
    q = rng.standard_normal((B, S, H, hd))
    k, v = (rng.standard_normal((B, S, K, hd)) for _ in range(2))
    do = rng.standard_normal((B, S, H, hd))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(attention64(*leaves, causal, window), leaves,
                               torch.from_numpy(do))

    def grads(dev):
        xs = [torch.from_numpy(x).float().to(dev).requires_grad_()
              for x in (q, k, v)]
        o = flash_attention(*xs, causal=causal, window=window)
        return [g.cpu().double() for g in torch.autograd.grad(
            o, xs, torch.from_numpy(do).float().to(dev))]

    plain = grads("cpu")
    before = flash_fwd.launches
    got = grads(cuda_device)
    assert flash_fwd.launches == before + 1
    for name, g, p, w in zip("qkv", got, plain, want):
        err, err_plain = (float((x - w).abs().max()) for x in (g, p))
        assert err <= 8 * err_plain, (name, err, err_plain)


def test_flash_wrapper_counts_and_rejects(cuda_device):
    q, k, v = (t.to(cuda_device) for t in flash_inputs(1, 8, 8, 4, 2, 16, 0))
    before = flash_fwd.launches
    flash_attention(q, k, v)
    assert flash_fwd.launches == before + 1
    with pytest.raises(TypeError):
        flash_fwd(q.double(), k, v)
    with pytest.raises(ValueError):
        flash_fwd(q.transpose(1, 2), k, v)            # not contiguous
    with pytest.raises(ValueError):
        flash_fwd(q[:, :, :3], k, v)                  # 3 heads over 2
    with pytest.raises(ValueError):
        flash_fwd(q, k, v.cpu())
    with pytest.raises(ValueError):
        flash_fwd(q, k, v, kv_len=torch.tensor(3, device=cuda_device))
    assert flash_fwd.launches == before + 1


def test_dense_serve_on_gpu_matches_cpu(cuda_device):
    """reduced stablelm-3b (4 layers) served on the card and on the CPU:
    the same logits, every attention call in the kernel, one a layer per
    prefill and per decode step."""
    gen = 4
    gpu = serve_on_both("stablelm-3b", cuda_device, requests=3,
                        prompt_len=48, gen_len=gen, shared_prefix_len=16,
                        seed=1)
    assert gpu["launches"]["flash_fwd"] == {"prefill": 4,
                                            "decode": 4 * (gen - 1)}


def test_hybrid_serve_on_gpu_matches_cpu(cuda_device):
    """reduced zamba2-1.2b (4 Mamba2 layers, the shared block after every
    2) served on the card and on the CPU: the same logits, one Mamba2
    scan a layer in the kernel per prefill (decode takes plain
    recurrence steps) and one attention call a shared-block application
    per prefill and per decode step."""
    gen = 4
    gpu = serve_on_both("zamba2-1.2b", cuda_device, requests=3,
                        prompt_len=48, gen_len=gen, shared_prefix_len=16,
                        seed=1)
    assert gpu["launches"] == {
        "ssd_chunked": {"prefill": 4, "decode": 0},
        "flash_fwd": {"prefill": 2, "decode": 2 * (gen - 1)}}


def test_moe_serve_on_gpu_matches_cpu(cuda_device):
    """reduced mixtral-8x7b (4 layers of 4 experts, one KV head, window 16
    under a 48-token prompt) served on the card and on the CPU: the same
    logits, every attention call in the kernel, one a layer per prefill
    and per decode step; the experts in plain products."""
    gen = 4
    gpu = serve_on_both("mixtral-8x7b", cuda_device, requests=3,
                        prompt_len=48, gen_len=gen, shared_prefix_len=16,
                        seed=1)
    assert gpu["launches"] == {
        "ssd_chunked": {"prefill": 0, "decode": 0},
        "flash_fwd": {"prefill": 4, "decode": 4 * (gen - 1)}}


@pytest.mark.parametrize("cf", [1.0, 1.25, 8.0])
def test_moe_einsum_equals_sort_on_gpu(cuda_device, cf):
    """The two dispatches on the card drop the same pairs and agree
    within 1e-5 scaled, and match the CPU's einsum dispatch."""
    from repro_torch.models import moe
    gen = torch.Generator(cuda_device).manual_seed(0)
    p = moe.moe_init(gen, 256, 512, 8, "swiglu", dense_ff=384)
    x = torch.randn((2, 256, 256), generator=gen, device=cuda_device)
    kw = dict(top_k=2, activation="swiglu", capacity_factor=cf)
    ye, ae = moe.moe_apply_einsum(p, x, **kw)
    ys, as_ = moe.moe_apply_sort(p, x, **kw)
    torch.cuda.synchronize()
    assert float((ye - ys).abs().max()) <= 1e-5 * max(
        1.0, float(ye.abs().max()))
    assert float(ae) == float(as_)
    cpu = {k: ({n: w.cpu() for n, w in v.items()} if isinstance(v, dict)
               else v.cpu()) for k, v in p.items()}
    yc, _ = moe.moe_apply_einsum(cpu, x.cpu(), **kw)
    assert float((ye.cpu() - yc).abs().max()) <= 1e-4 * max(
        1.0, float(yc.abs().max()))


def paged_inputs(B, K, G, hd, N, page, P_max, lengths, seed):
    """Normal q and pools, a table of random slots (entries past each
    length included), int32 lengths; on the CPU."""
    rng = np.random.default_rng(seed)
    f32 = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))
    table = torch.from_numpy(rng.integers(0, N, (B, P_max)).astype(np.int32))
    return (f32(B, K, G, hd), f32(K, N, page, hd), f32(K, N, page, hd),
            table, torch.tensor(lengths, dtype=torch.int32))


# (B, K, G, hd, N, page, P_max, lengths): stablelm-3b's heads (G 1, hd
# 80; at B 3 and B 8), mixtral's GQA (G 4, hd 128), granite's MQA (K 1,
# G 48: six blocks of query heads), pages of 16, 12, 5, 3 and 1 tokens, a
# head that is no multiple of 4 (scalar staging), a length past the
# table's capacity
@pytest.mark.parametrize("B,K,G,hd,N,page,P_max,lengths", [
    (3, 4, 1, 80, 64, 8, 20, [1, 157, 160]),
    (8, 32, 1, 80, 64, 8, 4, [1, 9, 17, 25, 32, 31, 30, 2]),
    (2, 2, 4, 128, 64, 8, 20, [33, 150]),
    (2, 1, 48, 128, 32, 8, 12, [96, 41]),
    (3, 2, 2, 64, 32, 16, 6, [16, 17, 90]),
    (2, 2, 4, 128, 40, 12, 9, [100, 13]),
    (2, 2, 3, 72, 40, 5, 9, [45, 7]),
    (2, 3, 8, 16, 16, 3, 7, [20, 21]),
    (2, 2, 2, 32, 64, 1, 40, [40, 9]),
    (2, 2, 2, 30, 16, 8, 5, [39, 2]),
    (2, 2, 1, 16, 16, 8, 3, [100, 24]),
])
def test_paged_kernel_vs_plain(cuda_device, B, K, G, hd, N, page, P_max,
                               lengths):
    args = paged_inputs(B, K, G, hd, N, page, P_max, lengths, B * hd + page)
    got = paged_decode(*(t.to(cuda_device) for t in args))
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    for plain in (paged_attention_online_ref, paged_attention_ref):
        torch.testing.assert_close(got.cpu(), plain(*args), rtol=2e-5,
                                   atol=2e-5)


def test_paged_kernel_never_reads_entries_past_the_length(cuda_device):
    """Entries past ceil(length / page) hold in-range garbage, then no
    pool slot at all (-1, N + 5): the same output, bit for bit, and no
    fault; a sequence of length 0 gives zeros."""
    N = 16
    q, kp, vp, table, lengths = paged_inputs(3, 2, 4, 80, N, 8, 6,
                                             [11, 0, 48], 9)
    far = table.clone()
    far[0, 2:] = torch.tensor([-1, N + 5, -1, N + 5])
    far[1, :] = N + 5
    outs = []
    for t in (table, far):
        outs.append(paged_decode(*(a.to(cuda_device) for a in (
            q, kp, vp, t, lengths))))
        torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert torch.isfinite(outs[1]).all() and not outs[1][1].any()
    torch.testing.assert_close(outs[1].cpu(),
                               paged_attention_online_ref(q, kp, vp, far,
                                                          lengths),
                               rtol=2e-5, atol=2e-5)


def test_paged_wrapper_counts_and_rejects(cuda_device):
    q, kp, vp, table, lengths = (t.to(cuda_device) for t in paged_inputs(
        2, 2, 2, 16, 8, 8, 3, [5, 20], 0))
    before = paged_decode.launches
    got = paged_attention(q.reshape(2, 4, 16), kp, vp, table.long(),
                          lengths.long())
    assert paged_decode.launches == before + 1 and got.shape == (2, 4, 16)
    with pytest.raises(ValueError):
        paged_decode(q.cpu(), kp.cpu(), vp.cpu(), table.cpu(), lengths.cpu())
    with pytest.raises(TypeError):
        paged_decode(q.double(), kp.double(), vp.double(), table, lengths)
    with pytest.raises(TypeError):
        paged_decode(q, kp, vp, table.long(), lengths)
    with pytest.raises(TypeError):
        paged_decode(q, kp, vp, table, lengths.long())
    with pytest.raises(ValueError):
        paged_decode(q, kp[:, :, :, ::2], vp[:, :, :, ::2], table, lengths)
    with pytest.raises(ValueError):
        paged_decode(q, kp, vp, table, lengths.cpu())
    assert paged_decode.launches == before + 1


@pytest.mark.parametrize("cur", [12, 14])
def test_decode_attention_full_cache_on_gpu_matches_cpu(cuda_device, cur):
    """Decoding into a full cache of 12 slots overwrites the last slot on
    the card as on the CPU, with no device assert."""
    rng = np.random.default_rng(cur)
    D, H, K, hd, S_max = 32, 4, 2, 16, 12
    p = {n: torch.from_numpy((rng.standard_normal(shape) / np.sqrt(
        shape[0])).astype(np.float32)) for n, shape in (
        ("wq", (D, H * hd)), ("wk", (D, K * hd)), ("wv", (D, K * hd)),
        ("wo", (H * hd, D)))}
    x = torch.from_numpy(rng.standard_normal((2, 1, D)).astype(np.float32))
    kc, vc = (torch.from_numpy(rng.standard_normal(
        (2, S_max, K, hd)).astype(np.float32)) for _ in range(2))
    kw = dict(n_heads=H, n_kv=K, hd=hd, rope_theta=1e4)
    cur_len = torch.tensor(cur, dtype=torch.int32)
    gpu = tattn.decode_attention(
        {n: a.to(cuda_device) for n, a in p.items()}, x.to(cuda_device),
        kc.to(cuda_device), vc.to(cuda_device), cur_len.to(cuda_device), **kw)
    torch.cuda.synchronize()
    cpu = tattn.decode_attention(p, x, kc.clone(), vc.clone(), cur_len, **kw)
    for g, c in zip(gpu, cpu):
        torch.testing.assert_close(g.cpu(), c, rtol=1e-4, atol=1e-4)

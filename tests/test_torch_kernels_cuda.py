"""The port's CUDA kernels and its sweep on the GPU, against their plain
PyTorch versions on the same inputs.  Every test needs a GPU and skips
without one; run them on a GPU host with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

This file imports neither jax nor the reference package, so it runs on a
host that has only torch and numpy."""
import dataclasses
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
from repro_torch.sim.sweep import (SweepPoint, closed_grid, run_sweep,
                                   sweep_grid)

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


def test_blocked_sweep_on_every_gpu_bitwise(cuda_device):
    """The closed grid dealt over every visible GPU (one block each)
    bitwise equal to one block, and to the CPU's blocks; one more device
    than visible raises."""
    count = torch.cuda.device_count()
    pts = closed_grid(threads=4, ops=32)[:5] + [
        SweepPoint(p_global=0.5, groups=4, threads=6, ops=48)]
    one = run_sweep(pts, loop="closed", devices=1, device=cuda_device)
    many = run_sweep(pts, loop="closed", devices=count, device=cuda_device)
    cpu = run_sweep(pts, loop="closed", devices=count, device="cpu")
    assert many.info["blocks"] == min(count, len(pts))
    for res in (many, cpu):
        for k, w in one.columns.items():
            assert np.array_equal(res.columns[k], w, equal_nan=True), k
    with pytest.raises(ValueError, match="CUDA devices visible"):
        run_sweep(pts, loop="closed", devices=count + 1, device=cuda_device)


@pytest.mark.parametrize("backend,wrapper", [("cuda", "maxplus_chunked"),
                                             ("ref", "maxplus_seq")])
def test_profile_maxplus_on_gpu(cuda_device, backend, wrapper):
    from repro_torch.obs import profile_maxplus
    kernel = getattr(mp_kernel, wrapper)
    before = kernel.launches
    out = profile_maxplus(n=4096, rows=8, backend=backend)
    assert set(out) == {"compile_s", "traces", "argument_bytes",
                        "output_bytes", "build_s", "device_ms",
                        "peak_bytes", "rows", "n"}
    assert out["device_ms"] > 0 and out["peak_bytes"] > 0
    assert out["compile_s"] > 0 and out["build_s"] >= 0
    assert out["argument_bytes"] == 2 * 8 * 4096 * 8
    assert out["output_bytes"] == 8 * 4096 * 8
    assert kernel.launches > before


def test_kernel_records_counts_every_launch(cuda_device):
    from repro_torch.obs.profile import irregular, kernel_records
    a = torch.linspace(0.0, 1.0, 8 * 4096, dtype=torch.float64,
                       device=cuda_device).reshape(8, 4096)
    s = torch.full((8, 4096), 1e-4, dtype=torch.float64, device=cuda_device)
    per = kernel_records(lambda: mp_kernel.maxplus_seq(a, s), calls=20)
    assert sum(n for n, _ in per.values()) == 20
    assert not irregular(per, 20)
    assert all(us > 0 for _, us in per.values())


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
# Sq 5, the fewest queries that take the tile configuration; then
# zamba2-1.2b's shared block (heads of 64): a row of its prefill and its
# decode over the cache's valid prefix; last seamless-m4t-large-v2's calls
# (16 heads of 64, K = H) at 2 requests: encoder self-attention (no mask),
# decoder self-attention (causal), cross-attention in prefill with a
# partial query tile and a partial KV tile (Sq != Skv), the decoder's
# decode over a 1056-slot cache with 1025 valid, and cross-attention in
# decode over every frame (no kv_len), at 1024 frames and at 1003.  Last
# the decode configuration's clusters: query groups of 1, 4 and 48 (MQA;
# at Sq 4 its 192 rows take 24 passes of 8) at Sq 1 to 4 under causal
# and window masks; a device kv_len of 0 (no valid key: zeros), 1, 70
# (two of 16 tiles: all but two of the 8 splits empty), at the 8-tile
# boundary where each split holds one tile and one either side (511, 512,
# 513); caches whose slots are not a multiple of 64; heads of 7, 64, 72,
# 80 and 128.  Last the padded heads at hd 128: deepseek-coder-33b at tp
# 16 with pad_kv (64 over 16), phi3-medium-14b at tp 16 (48 over 16, G =
# 3: a one-pass cluster's 4 rows part empty) and granite-20b's MQA (48
# over 1: six passes of 8 rows), prefill and decode over the serve
# cache, and the G = 3 decode over an empty cache (device kv_len 0); last
# internvl2-76b's (64 over 8, G = 8: one pass of 8 rows a cluster), its
# prefill over 256 patches and 1024 tokens, S 1280, and its decode over
# the 1312-slot serve cache with 1281 valid
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
    (2, 1024, 1024, 16, 16, 64, False, 0, None),
    (2, 1024, 1024, 16, 16, 64, True, 0, None),
    (2, 1000, 1030, 16, 16, 64, False, 0, None),
    (2, 1, 1056, 16, 16, 64, False, 0, 1025),
    (2, 1, 1024, 16, 16, 64, False, 0, None),
    (2, 1, 1003, 16, 16, 64, False, 0, None),
    (2, 1, 300, 4, 4, 64, False, 0, 200),
    (2, 2, 300, 8, 2, 64, True, 0, None),
    (2, 4, 300, 8, 2, 80, True, 3, None),
    (2, 1, 1056, 32, 8, 128, False, 0, 1025),
    (2, 1, 1056, 48, 1, 128, False, 0, 1025),
    (1, 4, 300, 48, 1, 128, True, 3, None),
    (1, 3, 130, 48, 1, 72, False, 0, 100),
    (2, 1, 1000, 8, 2, 64, False, 0, 0),
    (2, 1, 1000, 8, 2, 7, False, 0, 1),
    (2, 1, 1000, 8, 2, 72, False, 0, 70),
    (2, 1, 1000, 8, 2, 80, False, 0, 511),
    (2, 1, 1000, 8, 2, 128, False, 0, 512),
    (2, 1, 1000, 8, 2, 64, False, 0, 513),
    (2, 2, 1000, 8, 2, 7, True, 0, 513),
    (1, 256, 256, 64, 16, 128, True, 0, None),
    (1, 256, 256, 48, 16, 128, True, 0, None),
    (1, 256, 256, 48, 1, 128, True, 0, None),
    (2, 1, 1056, 64, 16, 128, False, 0, 1025),
    (2, 1, 1056, 48, 16, 128, False, 0, 1025),
    (2, 1, 1056, 48, 16, 128, False, 0, 0),
    (1, 1280, 1280, 64, 8, 128, True, 0, None),
    (2, 1, 1312, 64, 8, 128, False, 0, 1281),
])
def test_flash_kernel_vs_plain(cuda_device, B, Sq, Skv, H, K, hd, causal,
                               window, kv_len):
    q, k, v = flash_inputs(B, Sq, Skv, H, K, hd, Sq * hd + Skv)
    kw = dict(causal=causal, window=window)
    # a host 0 means every slot (the TPU kernel's seq_k); the device int32
    # 0 of an empty cache means none
    n0 = torch.tensor(0, dtype=torch.int32) if kv_len == 0 else kv_len
    want = flash_attention(q, k, v, kv_len=n0, **kw)
    lens = [kv_len] if kv_len is None else [
        kv_len, torch.tensor(kv_len, dtype=torch.int32, device=cuda_device)]
    if kv_len == 0:
        lens = lens[1:]
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
                                seq_k=0 if kv_len is None else n0, **kw)
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


@pytest.mark.parametrize("arch,over,tp,pad_kv,heads", [
    ("deepseek-coder-33b", dict(n_heads=56, n_kv_heads=8, head_dim=4), 16,
     True, (64, 16)),
    ("phi3-medium-14b", dict(n_heads=40, n_kv_heads=10, head_dim=4), 16,
     False, (48, 16)),
])
def test_padded_serve_on_gpu_matches_cpu(cuda_device, arch, over, tp,
                                         pad_kv, heads):
    """deepseek-like and phi3-like reduced configs built at their padded
    heads, served on the card and on the CPU with the card's weights: the
    same logits, one flash launch a layer per prefill and decode step."""
    cfg = dataclasses.replace(reduced(get_config(arch)), **over)
    model = init_params(cfg, 1, device=cuda_device, tp=tp, pad_kv=pad_kv)
    assert model.layers[0].attn["wk"].shape[1] == heads[1] * 4
    kw = dict(requests=3, prompt_len=48, gen_len=4, shared_prefix_len=16,
              seed=1)
    gpu = serve(device=cuda_device, params=model, **kw)
    cpu = serve(device="cpu", params=model.cpu(),
                teacher_tokens=gpu["tokens"], **kw)
    err = np.abs(gpu["logits"] - cpu["logits"]).max()
    assert err <= 1e-4 * max(1.0, np.abs(cpu["logits"]).max()), err
    assert gpu["launches"]["flash_fwd"] == {"prefill": 4, "decode": 4 * 3}


def test_uneven_padded_groups_raise_on_gpu(cuda_device):
    """phi3-like at tp 8 (40 query heads over 16 KV heads) raises
    ValueError on the card before any flash launch."""
    from repro_torch.models import prefill
    cfg = dataclasses.replace(reduced(get_config("phi3-medium-14b")),
                              n_heads=40, n_kv_heads=10, head_dim=4)
    model = init_params(cfg, 1, device=cuda_device, tp=8)
    before = flash_fwd.launches
    with pytest.raises(ValueError, match="not a multiple"):
        prefill(model, cfg, torch.zeros((2, 16), dtype=torch.long,
                                        device=cuda_device))
    assert flash_fwd.launches == before


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


def test_audio_serve_on_gpu_matches_cpu(cuda_device):
    """reduced seamless-m4t-large-v2 (2 encoder and 4 decoder layers) on
    48 frames a request served on the card and on the CPU: the same
    logits, every attention call in the kernel: one an encoder layer and
    two (self and cross) a decoder layer per prefill, two a decoder layer
    per decode step."""
    gen = 4
    gpu = serve_on_both("seamless-m4t-large-v2", cuda_device, requests=3,
                        prompt_len=48, gen_len=gen, shared_prefix_len=16,
                        seed=1)
    assert gpu["launches"] == {
        "ssd_chunked": {"prefill": 0, "decode": 0},
        "flash_fwd": {"prefill": 2 + 2 * 4, "decode": 2 * 4 * (gen - 1)}}


@pytest.mark.parametrize("over", [{}, dict(n_heads=16, n_kv_heads=2)])
def test_vlm_serve_on_gpu_matches_cpu(cuda_device, over):
    """reduced internvl2-76b (4 layers, 4 query heads over 1, and at the
    full config's G 8, 16 over 2) on 8 patch embeddings and 48 tokens a
    request, served on the card and on the CPU with the card's weights
    and tokens: the same logits, one flash launch a layer per prefill and
    per decode step."""
    gen = 4
    cfg = dataclasses.replace(reduced(get_config("internvl2-76b")), **over)
    model = init_params(cfg, 1, device=cuda_device)
    kw = dict(requests=3, prompt_len=48, gen_len=gen, shared_prefix_len=16,
              seed=1)
    gpu = serve(device=cuda_device, params=model, **kw)
    cpu = serve(device="cpu", params=model.cpu(),
                teacher_tokens=gpu["tokens"], **kw)
    err = np.abs(gpu["logits"] - cpu["logits"]).max()
    assert err <= 1e-4 * max(1.0, np.abs(cpu["logits"]).max()), err
    assert gpu["launches"]["flash_fwd"] == {"prefill": 4,
                                            "decode": 4 * (gen - 1)}


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


def int8_inputs(B, Sq, Skv, H, K, hd, seed):
    """q and an int8 K/V cache with its scales, the K/V quantized by the
    port's _quant_kv from seeded float32 values."""
    q, k, v = flash_inputs(B, Sq, Skv, H, K, hd, seed)
    (k8, ks), (v8, vs) = tattn._quant_kv(k), tattn._quant_kv(v)
    return q, k8, v8, ks, vs


def at_offset(t, offset):
    """A contiguous copy of the int8 tensor t whose data starts ``offset``
    bytes past a 16-byte boundary (a slice of a larger buffer)."""
    buf = torch.empty(t.numel() + 32, dtype=t.dtype, device=t.device)
    start = -buf.data_ptr() % 16 + offset
    out = buf[start:start + t.numel()].view(t.shape)
    out.copy_(t)
    return out


# the int8 decode instance: (B, Sq, Skv, H, K, hd, causal, window,
# kv_len, offset).  stablelm-3b (hd 80), mixtral-8x7b (hd 128 GQA),
# seamless's decoder (hd 64) and granite-20b's MQA (48 over 1 head of
# 128) at the serve cache's 1056 slots with 1025 valid and full; Sq 1 to
# 4 under causal and window masks; a device kv_len of 0 (no key), 1, 64
# and 65 (a tile's edge) and every slot; a head that ends inside a
# thread's columns (7, copied a byte a lane); heads copied 4 bytes at a
# time (36, 72, 100); one key on either side of a round of the CTA's 8
# warps (64 keys) and of a wrap of their 4-step rings (256), in one
# split (B K = 128 pairs); codes starting 4, 8 and 1 bytes past a
# 16-byte boundary (copies of 4, 4 and 1 bytes at hd 80); the padded
# heads of deepseek-coder-33b (64 over 16) and phi3-medium-14b (48 over
# 16, G = 3), also over an empty cache; internvl2-76b's G = 8 (64 over 8,
# the 8-row instance) over its 1312-slot serve cache, 1281 valid, and over
# a cache with only its 256 patches
INT8_CASES = [
    (2, 1, 1056, 32, 32, 80, False, 0, 1025, 0),
    (2, 1, 1056, 32, 8, 128, False, 0, 1025, 0),
    (2, 1, 1056, 16, 16, 64, False, 0, 1025, 0),
    (2, 1, 1056, 48, 1, 128, False, 0, 1025, 0),
    (2, 1, 1056, 32, 32, 80, False, 0, 1056, 0),
    (2, 1, 1056, 48, 1, 128, False, 0, None, 0),
    (2, 2, 300, 8, 2, 64, True, 0, None, 0),
    (2, 3, 300, 8, 2, 80, True, 3, None, 0),
    (1, 4, 300, 48, 1, 128, True, 3, None, 0),
    (2, 4, 200, 4, 4, 80, False, 0, 150, 0),
    (2, 1, 1000, 8, 2, 64, False, 0, 0, 0),
    (2, 1, 1000, 8, 2, 80, False, 0, 1, 0),
    (2, 1, 1000, 8, 2, 128, False, 0, 64, 0),
    (2, 1, 1000, 8, 2, 80, False, 0, 65, 0),
    (2, 2, 1000, 32, 8, 128, False, 0, 64, 0),
    (2, 3, 130, 4, 4, 64, False, 0, 65, 0),
    (2, 1, 1000, 8, 2, 7, False, 0, 513, 0),
    (2, 1, 1000, 8, 2, 36, False, 0, 513, 0),
    (2, 2, 300, 16, 4, 72, True, 0, None, 0),
    (2, 1, 1000, 8, 2, 100, False, 0, 777, 0),
    (1, 4, 300, 48, 1, 100, True, 5, None, 0),
    (4, 1, 300, 32, 32, 80, False, 0, 63, 0),
    (4, 1, 300, 32, 32, 80, False, 0, 64, 0),
    (4, 1, 300, 32, 32, 80, False, 0, 65, 0),
    (4, 1, 300, 32, 32, 80, False, 0, 255, 0),
    (4, 1, 300, 32, 32, 80, False, 0, 256, 0),
    (4, 1, 300, 32, 32, 80, False, 0, 257, 0),
    (2, 1, 1056, 32, 32, 80, False, 0, 1025, 4),
    (2, 1, 1056, 32, 32, 80, False, 0, 1025, 8),
    (2, 1, 1056, 32, 32, 80, False, 0, 1025, 1),
    (2, 1, 1056, 64, 16, 128, False, 0, 1025, 0),
    (2, 1, 1056, 48, 16, 128, False, 0, 1025, 0),
    (2, 1, 1056, 48, 16, 128, False, 0, 0, 0),
    (2, 1, 1312, 64, 8, 128, False, 0, 1281, 0),
    (2, 1, 1312, 64, 8, 128, False, 0, 256, 0),
]


@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,causal,window,kv_len,offset",
                         INT8_CASES)
def test_flash_int8_decode_vs_plain(cuda_device, B, Sq, Skv, H, K, hd,
                                    causal, window, kv_len, offset):
    from repro_torch.kernels.flash_attention import kernel
    q, k8, v8, ks, vs = int8_inputs(B, Sq, Skv, H, K, hd, Sq * hd + Skv)
    kw = dict(causal=causal, window=window)
    n = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    want = flash_attention(q, k8, v8, kv_len=n, kv_scales=(ks, vs), **kw)
    gq, gks, gvs = (t.to(cuda_device) for t in (q, ks, vs))
    gk8, gv8 = (at_offset(t.to(cuda_device), offset) for t in (k8, v8))
    assert gk8.data_ptr() % 16 == offset and gk8.is_contiguous()
    gn = None if n is None else n.to(cuda_device)
    before = flash_fwd.launches
    got = flash_attention(gq, gk8, gv8, kv_len=gn, kv_scales=(gks, gvs),
                          **kw)
    torch.cuda.synchronize()
    assert flash_fwd.launches == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=2e-5)
    # bitwise the float instance over the dequantized cache, at the same
    # key splits
    n_split = kernel.int8_decode_splits(
        B * K, H // K * Sq, Skv, kernel._sm_count(gq.device.index or 0))
    deq = kernel._launch(gq, (k8.float() * ks).to(cuda_device),
                         (v8.float() * vs).to(cuda_device), causal, window,
                         gn, n_split)
    assert torch.equal(got, deq)


def test_quant_kv_on_gpu_bitwise(cuda_device):
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal((8, 33, 4, 80))
                          * 10.0 ** rng.uniform(-8, 3, (8, 33, 4, 1))
                          ).astype(np.float32))
    x[0, 0, 0] = 0.0
    x[1, 0, 0] = torch.arange(80) - 39.5    # amax 39.5: halves of codes
    want = tattn._quant_kv(x)
    got = tattn._quant_kv(x.to(cuda_device))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)


def test_flash_int8_wrapper_rejects(cuda_device):
    q, k8, v8, ks, vs = (t.to(cuda_device)
                         for t in int8_inputs(1, 1, 64, 4, 2, 16, 0))
    before = flash_fwd.launches
    flash_fwd(q, k8, v8, causal=False, kv_scales=(ks, vs))
    assert flash_fwd.launches == before + 1
    q5 = torch.zeros((1, 5, 4, 16), device=cuda_device)
    with pytest.raises(ValueError, match="decode"):    # Sq 5: no tile
        flash_fwd(q5, k8, v8, causal=False, kv_scales=(ks, vs))
    with pytest.raises(ValueError):                    # mis-shaped scales
        flash_fwd(q, k8, v8, causal=False, kv_scales=(ks[:, :32], vs))
    with pytest.raises(ValueError):
        flash_fwd(q, k8, v8, causal=False,
                  kv_scales=(ks.reshape(1, 64, 2), vs))
    with pytest.raises(ValueError):                    # not contiguous
        flash_fwd(q, k8, v8, causal=False, kv_scales=(
            torch.ones((1, 2, 64, 1), device=cuda_device).transpose(1, 2),
            vs))
    with pytest.raises(TypeError):                     # float64 scales
        flash_fwd(q, k8, v8, causal=False, kv_scales=(ks.double(), vs))
    with pytest.raises(TypeError):                     # float K/V, scales
        flash_fwd(q, k8.float(), v8.float(), causal=False,
                  kv_scales=(ks, vs))
    with pytest.raises(TypeError):                     # int8, no scales
        flash_fwd(q, k8, v8, causal=False)
    with pytest.raises(ValueError):
        flash_fwd(q, k8, v8, causal=False, kv_scales=(ks.cpu(), vs))
    assert flash_fwd.launches == before + 1


def test_int8_decode_step_on_gpu_matches_cpu(cuda_device):
    """reduced stablelm-3b decoding 12 tokens through an int8 cache of 8
    slots (the last overwritten from step 8 on), on the card and on the
    CPU from the same cache a step: logits within 1e-4 scaled, the new
    slot's codes within 1."""
    from repro_torch.models import decode_step, init_cache
    cfg = reduced(get_config("stablelm-3b"))
    model = init_params(cfg, 0)
    gmodel = init_params(cfg, 0, device=cuda_device)
    gmodel.load_state_dict(model.state_dict())
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 12)))
    cache = init_cache(model, cfg, 2, 8, kv_dtype="int8")
    for t in range(12):
        gl, gc = decode_step(gmodel, cfg,
                             {k: v.to(cuda_device) for k, v in cache.items()},
                             toks[:, t:t + 1].to(cuda_device))
        torch.cuda.synchronize()
        cl, cache = decode_step(model, cfg, cache, toks[:, t:t + 1])
        err = float((gl.cpu() - cl).abs().max())
        assert err <= 1e-4 * max(1.0, float(cl.abs().max())), (t, err)
        slot = min(t, 7)
        for k in ("k", "v"):
            d = (gc[k][:, :, slot].cpu().int() - cache[k][:, :, slot].int())
            assert int(d.abs().max()) <= 1, (t, k)


# ------------------------------------------------ the mesh layer's rules
def test_quantize_int8_on_gpu_bitwise(cuda_device):
    """Codes and scales on the card equal the CPU's (which
    tests/test_torch_compression.py holds bitwise to the reference),
    also where the scale's product with the reciprocal of 127 would
    round differently from the division (amax 5.44259)."""
    from repro_torch.distributed.compression import ef_compress, quantize_int8
    amax = np.float32(5.44259)
    assert amax * (np.float32(1) / np.float32(127)) != amax / np.float32(127)
    rng = np.random.default_rng(0)
    cases = [rng.standard_normal((64, 80)) * 10.0 ** k for k in (-6, 0, 6)]
    x = rng.uniform(-1, 1, (33, 80)) * amax
    x[0, 0] = -amax
    cases += [x, np.zeros((7, 5))]
    for x in cases:
        x = torch.from_numpy(x.astype(np.float32))
        for got, want in zip(quantize_int8(x.to(cuda_device)),
                             quantize_int8(x)):
            assert got.dtype == want.dtype and torch.equal(got.cpu(), want)
        r = x * 1e-3
        for got, want in zip(ef_compress(x.to(cuda_device),
                                         r.to(cuda_device)),
                             ef_compress(x, r)):
            assert torch.equal(got.cpu(), want)


def test_meta_build_allocates_nothing_on_gpu(cuda_device):
    """``init_params(device="meta")`` and what follows the model's device
    (the int8 cache, both optimizers' states) leave the card's allocated
    memory where it was, at arctic-480b's full size."""
    from torch.utils._pytree import tree_leaves

    from repro_torch.models import init_cache
    from repro_torch.optim import adafactor, adamw
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda_device)
    cfg = get_config("arctic-480b")
    model = init_params(cfg, 0, dtype=torch.bfloat16, device="meta", tp=16,
                        pad_kv=True)
    params = dict(model.named_parameters())
    tensors = [*params.values(),
               *init_cache(model, cfg, 128, 32768, kv_dtype="int8").values(),
               *tree_leaves(adamw().init(params)),
               *tree_leaves(adafactor().init(params))]
    assert tensors and all(t.is_meta for t in tensors)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(cuda_device) == before


def test_compressed_psum_over_nccl(cuda_device):
    """The one-rank host mesh on the card runs NCCL; the sum over its
    "data" group is the rank's own dequantized codes, and the CPU's."""
    import torch.distributed as dist
    from repro_torch.distributed.compression import (compressed_psum,
                                                     dequantize_int8,
                                                     quantize_int8)
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh()
    try:
        assert (mesh.device_type == "cuda"
                and "nccl" in str(dist.get_backend()))
        x = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (257, 1000)).astype(np.float32))
        got = compressed_psum(x.to(cuda_device), mesh.get_group("data"))
        assert torch.equal(got, dequantize_int8(*quantize_int8(
            x.to(cuda_device))))
        assert torch.equal(got.cpu(), dequantize_int8(*quantize_int8(x)))
    finally:
        dist.destroy_process_group()

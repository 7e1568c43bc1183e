"""The port's flash attention and attention layers against the JAX
reference on the CPU: the plain versions the port runs there against the
reference's Pallas kernel (interpret mode) and its jnp path, RoPE, the
prefill sub-layer and the one-token decode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention import flash_attention_kernel as jax_kernel
from repro.kernels.flash_attention import flash_attention_ref as jax_ref
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_chunked_ref,
                                                 flash_attention_ref,
                                                 flash_fwd)
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers

TOL = 2e-5   # the reference kernel tests' own (tests/test_kernels_flash.py)
MODEL_TOL = 1e-4   # projections around attention: scaled by max |ref|


def rand_qkv(seed, B, S, H, K, hd, Skv=None):
    rng = np.random.default_rng(seed)
    Skv = S if Skv is None else Skv
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, K, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, K, hd)).astype(np.float32))


def port(q, k, v, **kw):
    return flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                           **kw).numpy()


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def scaled_close(got, want, tol=MODEL_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * max(1.0, float(np.max(np.abs(want)))), err


# every case of tests/test_kernels_flash.py: (B, S, H, K, hd, causal,
# window, bq, bk)
CASES = {
    "causal": (2, 64, 4, 4, 32, True, 0, 16, 16),
    "gqa": (2, 64, 4, 2, 32, True, 0, 32, 16),
    "mqa": (2, 96, 8, 1, 64, True, 0, 32, 32),
    "ragged33": (2, 33, 4, 4, 32, True, 0, 16, 16),
    "hd16": (2, 128, 2, 2, 16, True, 0, 64, 64),
    "window8": (1, 64, 4, 2, 32, True, 8, 16, 16),
    "window17": (1, 64, 4, 2, 32, True, 17, 16, 16),
    "window64": (1, 64, 4, 2, 32, True, 64, 16, 16),
    "non_causal": (2, 48, 4, 4, 32, False, 0, 16, 16),
}


@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["pallas_interpret", "jnp"])
@pytest.mark.parametrize("case", list(CASES))
def test_flash_ops_match_the_reference(case, use_pallas):
    B, S, H, K, hd, causal, window, bq, bk = CASES[case]
    q, k, v = rand_qkv(len(case), B, S, H, K, hd)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, window=window, use_pallas=use_pallas,
                     interpret=True, block_q=bq, block_k=bk)
    close(port(q, k, v, causal=causal, window=window), want)


@pytest.mark.parametrize("kv_len", [1, 17, 64, 70])
def test_decode_case_matches_the_reference(kv_len):
    """One query over a cache of 80 slots of which ``kv_len`` are valid,
    non-causal: the TPU kernel's seq_k mask, the decode path's call."""
    q, k, v = rand_qkv(kv_len, 2, 1, 4, 2, 16, Skv=80)
    ref_path = jattn.gqa_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=False,
                                   kv_len=jnp.asarray(kv_len), chunk=32)
    got = port(q, k, v, causal=False, kv_len=torch.tensor(kv_len,
                                                          dtype=torch.int32))
    close(got, ref_path)
    close(port(q, k, v, causal=False, kv_len=kv_len), ref_path)
    # and the Pallas kernel itself, heads folded, padded to its blocks
    fold = lambda a, G: np.repeat(a.transpose(0, 2, 1, 3), G, axis=1
                                  ).reshape(-1, a.shape[1], 16)
    qf = np.pad(fold(q, 1), ((0, 0), (0, 15), (0, 0)))
    kern = jax_kernel(jnp.asarray(qf), jnp.asarray(fold(k, 2)),
                      jnp.asarray(fold(v, 2)), causal=False, block_q=16,
                      block_k=16, seq_q=1, seq_k=kv_len, interpret=True)
    close(got, np.asarray(kern)[:, :1].reshape(2, 4, 1, 16).transpose(
        0, 2, 1, 3))


@pytest.mark.parametrize("causal,window,seq_q,seq_k", [
    (True, 0, 0, 0), (True, 5, 0, 0), (False, 0, 20, 9), (True, 3, 7, 19),
    (False, 9, 0, 0)])
def test_plain_versions_match_the_reference_oracle(causal, window, seq_q,
                                                   seq_k):
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((3, 24, 8)).astype(np.float32)
               for _ in range(3))
    want = jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, window=window, seq_q=seq_q, seq_k=seq_k)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    kw = dict(causal=causal, window=window, seq_q=seq_q, seq_k=seq_k)
    close(flash_attention_ref(*args, **kw), want)
    close(flash_attention_chunked_ref(*args, **kw), want)


def test_masked_rows_give_zeros_not_nan():
    """NEG_INF is finite and the exponential is re-masked by a select: a
    query whose keys are all masked (window past every key in its chunk,
    or no valid key at all) gives 0, and the others stay finite."""
    q, k, v = (torch.from_numpy(a) for a in rand_qkv(3, 1, 100, 2, 2, 16))
    out = flash_attention(q, k, v, causal=False,
                          kv_len=torch.tensor(0, dtype=torch.int32))
    assert torch.equal(out, torch.zeros_like(out))
    qf, kf, vf = (t.transpose(1, 2).reshape(2, 100, 16) for t in (q, k, v))
    # keys 0..63 fill the first chunk; with seq_k 70 and a causal window
    # of 3, queries 66.. see no key of the first chunk at all
    got = flash_attention_chunked_ref(qf, kf, vf, causal=True, window=3,
                                      seq_k=70)
    want = flash_attention_ref(qf, kf, vf, causal=True, window=3, seq_k=70)
    assert torch.isfinite(got).all()
    close(got, want)
    assert torch.equal(got[:, 72:], torch.zeros_like(got[:, 72:]))


def _tf32(x):
    """float32 rounded to TF32: 10 mantissa bits, to nearest, ties away
    from zero (PTX cvt.rna.tf32.f32 on finite values)."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _tf32_product(a, b, passes):
    """a @ b as the kernel's mma.sync passes compute it, float32 sums: one
    TF32 pass, or 3xTF32 (x = hi + lo, both TF32; hi lo + lo hi, then hi
    hi; lo lo dropped)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if passes == 1:
        return a_hi @ b_hi
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (a_hi @ b_lo + a_lo @ b_hi) + a_hi @ b_hi


def test_3xtf32_split_meets_flash_tol(record_property):
    """The tile configuration of the CUDA kernel runs q k^T and p v on the
    tensor cores, whose inputs are TF32.  One TF32 pass keeps 10 of
    float32's 23 mantissa bits and lands about 1e-3 from float64 here, 50x
    the reference kernel tests' 2e-5 (and one TF32 pass on the model's
    products misses the 1e-4 logit bound), so plain TF32 stays forbidden.
    Splitting each operand into two TF32 terms and summing three products
    leaves only the lo lo term and the split's remainder, both below 2^-22
    of the product: the result stays within float32's own rounding (about
    6e-7 here), which is why the kernel may use this scheme.  Emulated in
    numpy at stablelm-3b's head width on a seeded causal case."""
    rng = np.random.default_rng(17)
    S, hd = 256, 80
    q, k, v = (rng.standard_normal((S, hd)).astype(np.float32)
               for _ in range(3))
    scale = np.float32(1.0 / np.sqrt(hd))
    causal = np.tril(np.ones((S, S), bool))

    def attention(passes):
        s = np.where(causal, _tf32_product(q, k.T, passes) * scale,
                     np.float32(-1e30))
        p = np.where(causal, np.exp(s - s.max(axis=1, keepdims=True)), 0)
        p = p.astype(np.float32)
        return _tf32_product(p, v, passes) / p.sum(axis=1, keepdims=True)

    s64 = (q.astype(np.float64) @ k.T.astype(np.float64)) * (hd ** -0.5)
    s64 = np.where(causal, s64, -np.inf)
    p64 = np.exp(s64 - s64.max(axis=1, keepdims=True))
    want = (p64 @ v.astype(np.float64)) / p64.sum(axis=1, keepdims=True)
    bound = TOL * max(1.0, float(np.abs(want).max()))
    err3 = float(np.abs(attention(3) - want).max())
    err1 = float(np.abs(attention(1) - want).max())
    record_property("err_3xtf32", err3)
    record_property("err_1xtf32", err1)   # recorded, not asserted
    assert err3 <= bound, (err3, bound)


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in rand_qkv(0, 1, 8, 2, 2, 16))
    launches = flash_fwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd(q, k, v)
    assert flash_fwd.launches == launches


@pytest.mark.parametrize("hd,theta", [(16, 1e4), (80, 1e4), (64, 5e5)])
def test_rope_matches_jax(hd, theta):
    """Half-split rotation, angles from integer positions up to the serve
    path's 1055 in float32."""
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 6, 3, hd)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4, 5], [1050, 1051, 1052, 1053, 1054,
                                         1055]], np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta)
    close(got, want, 1e-5)
    close(tlayers.rope_freqs(hd, theta), jlayers.rope_freqs(hd, theta), 1e-7)


def attn_params(seed, D, H, K, hd):
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(
        np.float32) for n, shape in (("wq", (D, H * hd)), ("wk", (D, K * hd)),
                                     ("wv", (D, K * hd)),
                                     ("wo", (H * hd, D)))}


def torch_params(p):
    return {n: torch.from_numpy(a) for n, a in p.items()}


@pytest.mark.parametrize("H,K,window", [(4, 4, 0), (4, 2, 0), (4, 1, 5)])
def test_attn_apply_matches_jax(H, K, window):
    D, hd, S = 32, 16, 20
    p = attn_params(H + K, D, H, K, hd)
    x = np.random.default_rng(1).standard_normal((2, S, D)).astype(
        np.float32)
    kw = dict(n_heads=H, n_kv=K, hd=hd, rope_theta=1e4, window=window)
    want = jattn.attn_apply({n: jnp.asarray(a) for n, a in p.items()},
                            jnp.asarray(x), chunk=8, **kw)
    got, k, v = tattn.attn_apply(torch_params(p), torch.from_numpy(x), **kw)
    scaled_close(got, want)
    # the K/V it hands the cache are the reference prefill's (proj_kv)
    want_k = jlayers.apply_rope(
        (jnp.asarray(x) @ p["wk"]).reshape(2, S, K, hd),
        jnp.arange(S)[None], 1e4)
    scaled_close(k, want_k)
    scaled_close(v, (x @ p["wv"]).reshape(2, S, K, hd))


# cur 12 and 14: a full cache of 12 slots, whose last slot the reference
# overwrites (dynamic_update_slice clamps its start)
@pytest.mark.parametrize("window,cur", [(0, 5), (0, 0), (8, 11), (0, 12),
                                        (0, 14)])
def test_decode_attention_matches_jax(window, cur):
    """One token into a cache of 12 slots (a ring of 8 under a window):
    the written slot, the output, and the cache updated in place."""
    D, H, K, hd = 32, 4, 2, 16
    S_max = 8 if window else 12
    p = attn_params(3, D, H, K, hd)
    rng = np.random.default_rng(cur)
    x = rng.standard_normal((2, 1, D)).astype(np.float32)
    kc = rng.standard_normal((2, S_max, K, hd)).astype(np.float32)
    vc = rng.standard_normal((2, S_max, K, hd)).astype(np.float32)
    kw = dict(n_heads=H, n_kv=K, hd=hd, rope_theta=1e4, window=window)
    want, wk, wv = jattn.decode_attention(
        {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x),
        jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(cur, jnp.int32), **kw)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got, gk, gv = tattn.decode_attention(
        torch_params(p), torch.from_numpy(x), tk, tv,
        torch.tensor(cur, dtype=torch.int32), **kw)
    scaled_close(got, want)
    scaled_close(gk, wk)
    scaled_close(gv, wv)
    assert gk is tk and gv is tv   # in place

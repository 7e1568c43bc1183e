"""The port's int8 KV cache against the JAX reference on the CPU, on the
same seeded numpy inputs and weights (``params_from_jax``): the
quantizer ``_quant_kv`` bitwise, ``init_cache(kv_dtype="int8")``'s keys,
dtypes, shapes and values, ``decode_attention(kv_scales=...)`` on the
same int8 cache (the new slot's codes and scales, in place, and the
output), ``decode_step`` one step at a time from the reference's own
cache, and the reference's contract that the int8 cache's logits stay
within 2% of the float cache's.  On the CPU the flash kernel's plain
version dequantizes the cache as the reference does."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import attention as jattn
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models.serving import init_cache as jax_init_cache
from repro_torch.configs import get_config, reduced
from repro_torch.models import attention as tattn
from repro_torch.models import decode_step, init_cache, init_params
from repro_torch.models.convert import params_from_jax

MODEL_TOL = 1e-4   # port vs reference, float32 on the CPU: scaled by max |ref|
SCALE_RTOL = 1e-6  # a scale is max |x| / 127: the projections' rounding
INT8_RTOL = 0.02   # tests/test_serving_features.py: int8 logits vs float
B = 2
ENC_LEN = 8        # frames of the audio family's cross K/V


def scaled_close(got, want, tol=MODEL_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * max(1.0, float(np.max(np.abs(want)))), err


def quant_inputs(case):
    """float32 (rows, hd) K/V rows for one quantizer case."""
    rng = np.random.default_rng(len(case))
    if case == "random":        # magnitudes from 1e-8 to 1e3 a row
        x = rng.standard_normal((64, 80)) * 10.0 ** rng.uniform(
            -8, 3, (64, 1))
    elif case == "half codes":  # amax 127: scale 1, x / scale exact .5s
        x = np.tile(np.arange(-126.5, 127.0, 1.0)[:80], (4, 1))
        x[:, 0] = 127.0
        x[2:, 0] = -127.0
    elif case == "zero rows":   # amax 0: the 1e-6 floor
        x = np.zeros((6, 16))
        x[3:] = rng.standard_normal((3, 16)) * 1e-9   # under the floor
    else:                       # +-amax in one row, amax alone, and sign
        x = rng.standard_normal((8, 64))
        x[:, 5] = 3.5
        x[:, 9] = -3.5
        x[4:, 9] = -4.0
    return x.astype(np.float32)


@pytest.mark.parametrize("case", ["random", "half codes", "zero rows",
                                  "plus minus amax"])
def test_quant_kv_bitwise(case):
    x = quant_inputs(case)
    jq, js = jattn._quant_kv(jnp.asarray(x))
    tq, ts = tattn._quant_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == x.shape[:-1] + (1,)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if case == "half codes":   # round half to even, as jnp.round
        # -125.5, -124.5, -123.5, -122.5
        assert tq[0, 1:5].tolist() == [-126, -124, -124, -122]
    if case == "zero rows":
        assert not tq.any() and bool((ts == np.float32(1e-6) / 127).all())


# reduced configs: (arch, the port's families that take an int8 K/V)
ARCHS = {"stablelm-3b": True, "mixtral-8x7b": True,
         "seamless-m4t-large-v2": True, "zamba2-1.2b": False,
         "xlstm-125m": False}


@functools.lru_cache(maxsize=None)
def load(arch, seed=0):
    jcfg = jax_reduced(jax_get_config(arch))
    cfg = reduced(get_config(arch))
    tree = jax.tree.map(np.asarray,
                        jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    model = init_params(cfg, 1)
    model.load_state_dict(params_from_jax(tree), strict=True)
    return jcfg, cfg, tree, model


@pytest.mark.parametrize("arch", list(ARCHS))
def test_init_cache_int8_matches_the_reference(arch):
    jcfg, cfg, tree, model = load(arch)
    enc = dict(enc_len=ENC_LEN) if cfg.encoder_layers else {}
    want = jax_init_cache(jax.tree.map(jnp.asarray, tree), jcfg, B, 24,
                          kv_dtype="int8", **enc)
    got = init_cache(model, cfg, B, 24, kv_dtype="int8", **enc)
    assert set(got) == set(want)
    assert ("ks" in got) == ARCHS[arch]
    for k, w in want.items():
        w = np.asarray(w)
        assert str(got[k].dtype).split(".")[-1] == str(w.dtype), k
        np.testing.assert_array_equal(got[k].numpy(), w)
    if ARCHS[arch]:
        assert got["k"].dtype == got["v"].dtype == torch.int8
        assert got["ks"].shape == got["k"].shape[:-1] + (1,)
    float_cache = init_cache(model, cfg, B, 24, **enc)
    for k in set(float_cache) - {"k", "v"}:   # the rest as without int8
        assert got[k].dtype == float_cache[k].dtype, k
    with pytest.raises(ValueError, match="kv_dtype"):
        init_cache(model, cfg, B, 24, kv_dtype="int4", **enc)


def attn_params(seed, D, H, K, hd):
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(
        np.float32) for n, shape in (("wq", (D, H * hd)), ("wk", (D, K * hd)),
                                     ("wv", (D, K * hd)), ("wo", (H * hd, D)))}


# (window, cur): mid-cache; a full cache without a window (the last slot
# overwritten, dynamic_update_slice's clamp); a window's ring wrapping
@pytest.mark.parametrize("window,cur", [(0, 5), (0, 12), (0, 15), (4, 13)])
def test_decode_attention_int8_matches_the_reference(window, cur):
    D, H, K, hd, S_max = 32, 4, 2, 16, 12
    p = attn_params(cur, D, H, K, hd)
    rng = np.random.default_rng(100 + cur)
    x = rng.standard_normal((B, 1, D)).astype(np.float32)
    codes, scales = [], []
    for _ in range(2):   # a cache written by the quantizer
        c, s = jattn._quant_kv(jnp.asarray(
            rng.standard_normal((B, S_max, K, hd)).astype(np.float32)))
        codes.append(np.asarray(c))
        scales.append(np.asarray(s))
    kw = dict(n_heads=H, n_kv=K, hd=hd, rope_theta=1e4, window=window)
    want, wk, wv, (wks, wvs) = jattn.decode_attention(
        {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x),
        *map(jnp.asarray, codes), jnp.asarray(cur, jnp.int32),
        kv_scales=tuple(map(jnp.asarray, scales)), **kw)
    tk, tv, tks, tvs = (torch.from_numpy(a.copy()) for a in (*codes,
                                                              *scales))
    got, gk, gv, (gks, gvs) = tattn.decode_attention(
        {n: torch.from_numpy(a) for n, a in p.items()}, torch.from_numpy(x),
        tk, tv, torch.tensor(cur, dtype=torch.int32), kv_scales=(tks, tvs),
        **kw)
    scaled_close(got, want)
    assert gk is tk and gv is tv and gks is tks and gvs is tvs  # in place
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    for g, w in ((gks, wks), (gvs, wvs)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=SCALE_RTOL,
                                   atol=0)
    slot = cur % S_max if window else min(cur, S_max - 1)
    assert not np.array_equal(gk.numpy()[:, slot], codes[0][:, slot])


def test_decode_attention_cache_and_scales_go_together():
    p = {n: torch.from_numpy(a) for n, a in attn_params(0, 16, 2, 2,
                                                        8).items()}
    kw = dict(n_heads=2, n_kv=2, hd=8, rope_theta=1e4)
    x, n = torch.zeros((1, 1, 16)), torch.tensor(0, dtype=torch.int32)
    k8 = torch.zeros((1, 4, 2, 8), dtype=torch.int8)
    s = torch.ones((1, 4, 2, 1))
    with pytest.raises(ValueError, match="kv_scales"):   # codes, no scales
        tattn.decode_attention(p, x, k8, k8.clone(), n, **kw)
    kf = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="kv_scales"):   # float, scales
        tattn.decode_attention(p, x, kf, kf.clone(), n, kv_scales=(s, s),
                               **kw)


def step_slot(cfg, S, t):
    """The slot decode step ``t`` (from an empty cache) writes."""
    return t % S if cfg.sliding_window else min(t, S - 1)


# (arch, max_len): stablelm-3b within its cache and past it (the last
# slot overwritten from step 12 on), mixtral-8x7b's window ring wrapping
# at 12 slots, seamless with its cross K/V; the other dense configs,
# granite-20b's MQA cache past full
DECODE_CASES = [("stablelm-3b", 16), ("stablelm-3b", 12),
                ("mixtral-8x7b", 12), ("seamless-m4t-large-v2", 16),
                ("deepseek-coder-33b", 16), ("granite-20b", 12),
                ("phi3-medium-14b", 16)]
STEPS = 16


def with_cross(cfg, cache, rng):
    """The audio family's cross K/V filled with seeded values (prefill's
    place), float32 as the reference keeps them."""
    if cfg.encoder_layers:
        for k in ("xk", "xv"):
            cache[k] = rng.standard_normal(cache[k].shape).astype(np.float32)
    return cache


@pytest.mark.parametrize("arch,max_len", DECODE_CASES)
def test_decode_step_int8_from_the_reference_cache(arch, max_len):
    jcfg, cfg, tree, model = load(arch)
    jparams = jax.tree.map(jnp.asarray, tree)
    jax_step = jax.jit(jax_decode_step, static_argnums=1)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (B, STEPS))
    enc = dict(enc_len=ENC_LEN) if cfg.encoder_layers else {}
    jc = {k: np.asarray(v) for k, v in jax_init_cache(
        jparams, jcfg, B, max_len, kv_dtype="int8", **enc).items()}
    jc = {k: jnp.asarray(v) for k, v in with_cross(cfg, jc, rng).items()}
    S = jc["k"].shape[2]
    flips = 0
    for t in range(STEPS):
        step = toks[:, t:t + 1]
        tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
        tl, tc = decode_step(model, cfg, tc, torch.from_numpy(step))
        jl, jc = jax_step(jparams, jcfg, jc, jnp.asarray(step, jnp.int32))
        scaled_close(tl, jl)
        assert set(tc) == set(jc) and int(tc["len"]) == int(jc["len"])
        slot = step_slot(cfg, S, t)
        for k in ("k", "v"):
            got = tc[k].numpy()[:, :, slot].astype(np.int32)
            want = np.asarray(jc[k])[:, :, slot].astype(np.int32)
            assert np.abs(got - want).max() <= 1, (t, k)
            flips += int((got != want).sum())
        for k in tc:    # every other entry as the reference's
            other = np.ones(tc[k].shape[2] if tc[k].dim() > 2 else 1, bool)
            if k in ("k", "v", "ks", "vs"):
                other[slot] = False
            got, want = tc[k].numpy(), np.asarray(jc[k])
            if tc[k].dim() > 2:
                got, want = got[:, :, other], want[:, :, other]
            np.testing.assert_array_equal(got, want)
        for k in ("ks", "vs"):
            np.testing.assert_allclose(tc[k].numpy()[:, :, slot],
                                       np.asarray(jc[k])[:, :, slot],
                                       rtol=SCALE_RTOL, atol=0)
    # codes rarely flip at a rounding boundary: the projections round
    # differently in the two frameworks
    assert flips <= 4, flips


def decode_all(cfg, model, cache, toks):
    for t in range(toks.shape[1]):
        logits, cache = decode_step(model, cfg, cache, toks[:, t:t + 1])
    return logits


@pytest.mark.parametrize("arch", ["stablelm-3b", "mixtral-8x7b",
                                  "seamless-m4t-large-v2"])
def test_int8_kv_cache_close_to_bf16(arch):
    """tests/test_serving_features.py's contract on the port: decoding 16
    tokens through an int8 cache gives logits within 2% (relative to the
    largest) of the float cache's, on the reference's weights and
    tokens."""
    jcfg, cfg, tree, model = load(arch)
    toks = torch.from_numpy(np.asarray(jax.random.randint(
        jax.random.PRNGKey(2), (B, 16), 0, jcfg.vocab_size)))
    enc = dict(enc_len=ENC_LEN) if cfg.encoder_layers else {}
    cross = {}
    if cfg.encoder_layers:
        rng = np.random.default_rng(3)
        shape = init_cache(model, cfg, B, 16, **enc)["xk"].shape
        cross = {k: torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)) for k in ("xk", "xv")}
    lb = decode_all(cfg, model, {**init_cache(model, cfg, B, 16, **enc),
                                 **cross}, toks)
    lq = decode_all(cfg, model, {**init_cache(model, cfg, B, 16,
                                              kv_dtype="int8", **enc),
                                 **cross}, toks)
    rel = float((lq - lb).abs().max() / (lb.abs().max() + 1e-9))
    assert rel < INT8_RTOL, rel

"""KV-head padding in the port against the JAX reference on the CPU:
``model_dims(cfg, tp, pad_kv)`` and ``init_params(..., tp=, pad_kv=)``
for every config, degree and flag; the reference's padded trees loaded
with ``strict=True`` (``params_from_jax``); prefill, teacher-forced
decode, the int8 cache's decode and ``forward_train``'s loss and
gradients at padded head counts for the dense, MoE, audio and hybrid
families, on the reference's weights and seeded numpy inputs; and a
padding whose query heads do not divide over its KV heads (phi3 at tp
8) raising in both packages."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import decode_step as jax_decode_step
from repro.models import dims_from_params as jax_dims_from_params
from repro.models import forward_train as jax_forward_train
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models.model import model_dims as jax_model_dims
from repro.models.serving import init_cache as jax_init_cache
from repro_torch.configs import SSM, get_config, reduced
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import (decode_step, dims_from_params, forward_train,
                                init_cache, init_params, prefill)
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.model import model_dims

TOL = 1e-4        # port vs reference, float32 on the CPU: scaled by max |ref|
TRAIN_TOL = 1e-5  # tests/test_torch_train.py's loss and gradient bound
INT8_RTOL = 0.02  # tests/test_serving_features.py: int8 logits vs float
B, S, STEPS, S_ENC = 2, 16, 8, 12
jax_step = jax.jit(jax_decode_step, static_argnums=1)


def scaled_close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * max(1.0, float(np.max(np.abs(want)))), err


def reduced_pair(arch, **over):
    """The reference's and the port's reduced ``arch`` with ``over``."""
    return (dataclasses.replace(jax_reduced(jax_get_config(arch)), **over),
            dataclasses.replace(reduced(get_config(arch)), **over))


def load(jcfg, cfg, tp, pad_kv, seed=0):
    """The reference's tree at (tp, pad_kv), loaded strictly into the
    port's model built at the same arguments."""
    tree = jax.tree.map(np.asarray, jax_init_params(
        jcfg, jax.random.PRNGKey(seed), tp=tp, pad_kv=pad_kv))
    model = init_params(cfg, 1, tp=tp, pad_kv=pad_kv)
    model.load_state_dict(params_from_jax(tree), strict=True)
    return tree, model


# ------------------------------------------------- dims, every config
def slim(cfg):
    """``cfg`` with its head counts and head width kept and everything
    else cut to a few numbers: the padded attention's shapes at almost
    no weight."""
    kw = dict(d_model=64, d_ff=64 if cfg.d_ff else 0, vocab_size=256,
              head_dim=cfg.hd, n_layers=max(1, cfg.shared_attn_every))
    if cfg.n_experts:
        kw.update(n_experts=2, top_k=1)
    if cfg.dense_ff:
        kw["dense_ff"] = 32
    if cfg.encoder_layers:
        kw["encoder_layers"] = 1
    if cfg.slstm_layers:
        kw.update(slstm_layers=(0,), n_layers=2)
    if cfg.frontend_tokens:
        kw["frontend_tokens"] = 4
    return dataclasses.replace(cfg, **kw)


@pytest.mark.parametrize("pad_kv", [False, True])
@pytest.mark.parametrize("tp", [1, 8, 16])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_dims_match_the_reference(arch, tp, pad_kv):
    """model_dims at the config itself; dims_from_params of the
    reference's full-size tree (shapes only, ``jax.eval_shape``) against
    the port's model at the same heads; the reference's tree at (tp,
    pad_kv) loading strictly into the port's."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    want = jax_model_dims(jcfg, tp, pad_kv)
    got = model_dims(cfg, tp, pad_kv)
    assert (got.H, got.K, got.hd) == (want.H, want.K, want.hd)
    shapes = jax.eval_shape(lambda: jax_init_params(
        jcfg, jax.random.PRNGKey(0), tp=tp, pad_kv=pad_kv))
    want = jax_dims_from_params(shapes, jcfg)
    _, model = load(slim(jcfg), slim(cfg), tp, pad_kv)
    got = dims_from_params(model, slim(cfg))
    assert (got.H, got.K, got.hd) == (want.H, want.K, want.hd)
    if cfg.family != SSM:   # the SSM family ignores tp and pad_kv
        assert (got.H, got.K) == cfg.padded_heads(tp, pad_kv)


# ------------------------------------ serving at padded head counts
# case -> (arch, config overrides of the reduced config, tp, pad_kv,
# padded (H, K)): reduced stablelm-3b (MHA, 4 over 4), a deepseek-like
# config (56 over 8, the full config's G = 7) at (64, 16), a phi3-like
# one (40 over 10) at (48, 16), G = 3; reduced mixtral-8x7b with 2 KV
# heads (MoE, its window a ring), reduced seamless (audio, the
# cross-attention padded too) and reduced zamba2 (the hybrid's shared
# block)
PADDED = {
    "stablelm-mha": ("stablelm-3b", {}, 8, True, (8, 8)),
    "deepseek-like": ("deepseek-coder-33b",
                      dict(n_heads=56, n_kv_heads=8, head_dim=4), 16, True,
                      (64, 16)),
    "phi3-like": ("phi3-medium-14b",
                  dict(n_heads=40, n_kv_heads=10, head_dim=4), 16, False,
                  (48, 16)),
    "mixtral": ("mixtral-8x7b", dict(n_kv_heads=2), 8, True, (8, 8)),
    "seamless": ("seamless-m4t-large-v2", {}, 8, True, (8, 8)),
    "zamba2": ("zamba2-1.2b", {}, 8, True, (8, 8)),
}


@functools.lru_cache(maxsize=None)
def padded_model(case):
    arch, over, tp, pad_kv, heads = PADDED[case]
    jcfg, cfg = reduced_pair(arch, **over)
    tree, model = load(jcfg, cfg, tp, pad_kv)
    return dict(jcfg=jcfg, cfg=cfg, tree=tree, model=model, heads=heads)


def frames(cfg, seed=1):
    """Frame embeddings for the audio family, else None."""
    if not cfg.encoder_layers:
        return None
    return np.random.default_rng(seed).standard_normal(
        (B, S_ENC, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("case", list(PADDED))
def test_prefill_and_decode_match_jax(case):
    """Prefill logits and every cache entry, then 8 teacher-forced decode
    steps, logits and caches, at the padded head counts."""
    padded = padded_model(case)
    jcfg, cfg, model = padded["jcfg"], padded["cfg"], padded["model"]
    H, K = padded["heads"]
    dims = dims_from_params(model, cfg)
    assert (dims.H, dims.K) == (H, K)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (B, S + STEPS))
    fr = frames(cfg)
    jparams = jax.tree.map(jnp.asarray, padded["tree"])
    jl, jc = jax_prefill(jparams, jcfg, jnp.asarray(toks[:, :S], jnp.int32),
                         max_len=S + STEPS, chunk=16,
                         **({} if fr is None else
                            dict(enc_frames=jnp.asarray(fr))))
    tl, tc = prefill(model, cfg, torch.from_numpy(toks[:, :S]),
                     max_len=S + STEPS,
                     **({} if fr is None else
                        dict(enc_frames=torch.from_numpy(fr))))
    scaled_close(tl, jl)
    assert set(tc) == set(jc)
    kv = "ak" if "ak" in tc else "k"
    assert tc[kv].shape[-2:] == (K, cfg.hd)
    for k in jc:
        scaled_close(tc[k], jc[k])
    for i in range(STEPS):
        step = toks[:, S + i:S + i + 1]
        jl, jc = jax_step(jparams, jcfg, jc, jnp.asarray(step, jnp.int32))
        tl, tc = decode_step(model, cfg, tc, torch.from_numpy(step))
        scaled_close(tl, jl)
        for k in jc:
            scaled_close(tc[k], jc[k])
    assert int(tc["len"]) == int(jc["len"]) == S + STEPS


# the int8 cache at the padded dense configs, the MoE family and the
# audio family (the hybrid's ak/av stay float32); 12 slots, so the last
# steps run past a full cache (mixtral's window ring wraps)
@pytest.mark.parametrize("case", ["stablelm-mha", "deepseek-like",
                                  "phi3-like", "mixtral", "seamless"])
def test_int8_decode_matches_jax(case):
    """decode_step through an int8 cache at the padded K, a step at a time
    from the reference's own cache: logits within TOL, the new slot's
    codes within 1, every other entry equal; then the reference's
    contract, the int8 logits within 2% of the float cache's."""
    padded = padded_model(case)
    jcfg, cfg, model = padded["jcfg"], padded["cfg"], padded["model"]
    K = padded["heads"][1]
    jparams = jax.tree.map(jnp.asarray, padded["tree"])
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (B, 16))
    enc = dict(enc_len=S_ENC) if cfg.encoder_layers else {}
    jc = {k: np.asarray(v) for k, v in jax_init_cache(
        jparams, jcfg, B, 12, kv_dtype="int8", **enc).items()}
    if cfg.encoder_layers:     # prefill's place: seeded cross K/V
        for k in ("xk", "xv"):
            jc[k] = rng.standard_normal(jc[k].shape).astype(np.float32)
    cross = {k: torch.from_numpy(jc[k].copy()) for k in ("xk", "xv")
             if k in jc}
    assert jc["k"].shape[-2] == jc["ks"].shape[-2] == K
    S_max = jc["k"].shape[2]
    flips = 0
    for t in range(toks.shape[1]):
        step = toks[:, t:t + 1]
        tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
        tl, tc = decode_step(model, cfg, tc, torch.from_numpy(step))
        jl, jc = jax_step(jparams, jcfg,
                          {k: jnp.asarray(v) for k, v in jc.items()},
                          jnp.asarray(step, jnp.int32))
        jc = {k: np.asarray(v) for k, v in jc.items()}
        scaled_close(tl, jl)
        slot = t % S_max if cfg.sliding_window else min(t, S_max - 1)
        for k in ("k", "v"):
            d = tc[k].numpy()[:, :, slot].astype(np.int32) - jc[k][
                :, :, slot].astype(np.int32)
            assert np.abs(d).max() <= 1, (t, k)
            flips += int((d != 0).sum())
            other = np.arange(S_max) != slot
            np.testing.assert_array_equal(tc[k].numpy()[:, :, other],
                                          jc[k][:, :, other])
    assert flips <= 4, flips

    def decode_all(cache):
        for t in range(toks.shape[1]):
            logits, cache = decode_step(model, cfg, cache,
                                        torch.from_numpy(toks[:, t:t + 1]))
        return logits

    lb = decode_all({**init_cache(model, cfg, B, 16, **enc), **cross})
    lq = decode_all({**init_cache(model, cfg, B, 16, kv_dtype="int8",
                                  **enc), **cross})
    rel = float((lq - lb).abs().max() / (lb.abs().max() + 1e-9))
    assert rel < INT8_RTOL, rel


# ------------------------------------------------------------ training
@pytest.mark.parametrize("case", ["stablelm-mha", "mixtral"])
def test_forward_train_matches_jax(case):
    """forward_train's loss and every parameter's gradient against
    ``jax.value_and_grad`` of the reference's, at the padded dims: the
    backward sums dK and dV over each KV head's query group."""
    padded = padded_model(case)
    jcfg, cfg, model = padded["jcfg"], padded["cfg"], padded["model"]
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab_size, (B, 32)).astype(np.int32)
             for k in ("tokens", "labels")}
    jloss, jgrads = jax.value_and_grad(lambda p: jax_forward_train(
        p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}))(
        jax.tree.map(jnp.asarray, padded["tree"]))
    named = dict(model.named_parameters())
    loss = forward_train(model, cfg, {k: torch.from_numpy(v).long()
                                      for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(named.values()))
    loss, jloss = float(loss.detach()), float(jloss)
    assert abs(loss - jloss) <= TRAIN_TOL * abs(jloss)
    got = jax.tree_util.tree_flatten_with_path(
        params_to_jax(dict(zip(named, grads))))[0]
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        err = float(np.max(np.abs(g - w)) / max(np.max(np.abs(w)), 1e-30))
        assert err <= TRAIN_TOL, jax.tree_util.keystr(path)


# ------------------------------------- the reference's contract, ported
def test_pad_kv_heads_preserves_outputs():
    """tests/test_serving_features.py::test_pad_kv_heads_preserves_outputs
    on the port: the padded dims divide tp = 8 and are at least the
    unpadded ones, and prefill gives finite logits of the same shape."""
    cfg = reduced(get_config("stablelm-3b"))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)))
    p1 = init_params(cfg, 0, tp=1)
    l1, _ = prefill(p1, cfg, toks)
    p2 = init_params(cfg, 0, tp=8, pad_kv=True)
    d1, d2 = dims_from_params(p1, cfg), dims_from_params(p2, cfg)
    assert d2.H % 8 == 0 and d2.K % 8 == 0
    assert d2.H >= d1.H and d2.K >= d1.K
    l2, _ = prefill(p2, cfg, toks)
    assert l2.shape == l1.shape
    assert torch.isfinite(l2).all()


def test_uneven_query_groups_raise_in_both_packages():
    """phi3-like at tp 8 pads its KV heads to 16 and leaves its 40 query
    heads as they are: 40 over 16.  The reference's prefill fails in its
    attention's reshape; the port's builds the model and raises
    ValueError from flash_attention before it attends, and decode
    likewise."""
    jcfg, cfg = reduced_pair("phi3-medium-14b", **PADDED["phi3-like"][1])
    dims, want = model_dims(cfg, 8), jax_model_dims(jcfg, 8)
    assert (dims.H, dims.K) == (want.H, want.K) == (40, 16)
    tree, model = load(jcfg, cfg, 8, False)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S))
    with pytest.raises(TypeError, match="reshape"):
        jax_prefill(jax.tree.map(jnp.asarray, tree), jcfg,
                    jnp.asarray(toks, jnp.int32), chunk=16)
    with pytest.raises(ValueError, match="40 query heads are not a "
                       "multiple of 16 KV heads"):
        prefill(model, cfg, torch.from_numpy(toks))
    cache = init_cache(model, cfg, B, S)
    with pytest.raises(ValueError, match="not a multiple"):
        decode_step(model, cfg, cache, torch.from_numpy(toks[:, :1]))
    q = torch.zeros((1, 2, 40, 4))
    with pytest.raises(ValueError, match="not a multiple"):
        flash_attention(q, torch.zeros((1, 2, 16, 4)),
                        torch.zeros((1, 2, 16, 4)))

"""The port's VLM family (internvl2-76b) against the JAX reference on the
same seeded numpy weights, patch embeddings and tokens: reduced
internvl2-76b (4 query heads over 1 KV head, 8 patches) and a variant at
the full config's ratio, 16 query heads over 2 (G 8).  Covered: the
weights loaded strictly, ``_embed`` with and without a prefix, prefill
logits and every cache entry with ``len`` = P + S_tok, teacher-forced
decode after a prefixed prefill, the int8 cache, KV-head padding at tp
16 with ``pad_kv``, ``forward_train``'s loss and every gradient,
``make_prefill_step``, the launcher against the reference's prefill and
decode on the launcher's prompts and patches, and a reduced training
loop.  On the CPU every attention call runs the flash kernel's plain
version."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import decode_step as jax_decode_step
from repro.models import forward_train as jax_forward_train
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models.attention import _quant_kv as jax_quant_kv
from repro.models.model import _embed as jax_embed
from repro.models.serving import init_cache as jax_init_cache
from repro.train.steps import make_prefill_step as jax_make_prefill_step
from repro_torch.configs import get_config, reduced
from repro_torch.data import SyntheticTokens
from repro_torch.kernels.flash_attention import flash_fwd
from repro_torch.launch.serve import serve
from repro_torch.models import (decode_step, dims_from_params, forward_train,
                                init_cache, init_params, prefill)
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.model import _embed
from repro_torch.train import loop as tloop
from repro_torch.train import make_prefill_step

TOL = 1e-4        # port vs reference, float32 on the CPU: scaled by max |ref|
TRAIN_TOL = 1e-5  # tests/test_torch_train.py's loss and gradient bound
INT8_RTOL = 0.02  # tests/test_serving_features.py: int8 logits vs float
ARCH = "internvl2-76b"
B, S_TOK, STEPS = 2, 12, 8
jax_step = jax.jit(jax_decode_step, static_argnums=1)

# reduced internvl2-76b (4 query heads over 1 KV head of 16) and the full
# config's ratio, 16 query heads over 2 (G 8)
VARIANTS = {"reduced": {}, "g8": dict(n_heads=16, n_kv_heads=2)}


def configs(variant):
    over = VARIANTS[variant]
    return (dataclasses.replace(jax_reduced(jax_get_config(ARCH)), **over),
            dataclasses.replace(reduced(get_config(ARCH)), **over))


def load(variant, tp=1, pad_kv=False, seed=0):
    """The reference's tree at (tp, pad_kv), loaded strictly into the
    port's model built at the same arguments."""
    jcfg, cfg = configs(variant)
    tree = jax.tree.map(np.asarray, jax_init_params(
        jcfg, jax.random.PRNGKey(seed), tp=tp, pad_kv=pad_kv))
    model = init_params(cfg, 1, tp=tp, pad_kv=pad_kv)
    model.load_state_dict(params_from_jax(tree), strict=True)
    return jcfg, cfg, tree, model


@pytest.fixture(scope="module", params=list(VARIANTS))
def models(request):
    return load(request.param)


def scaled_close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * max(1.0, float(np.max(np.abs(want)))), err


def patches_of(cfg, seed, batch=B):
    """The stubbed vision frontend's output: ``frontend_tokens`` patch
    embeddings a sequence, (batch, P, d_model) float32."""
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)


def tokens_of(cfg, seed, n):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n))


def test_weights_load_strictly_and_round_trip(models):
    jcfg, cfg, tree, model = models
    back = params_to_jax(params_from_jax(tree))
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert np.array_equal(a, b)
    dims = dims_from_params(model, cfg)
    assert (dims.H, dims.K, dims.hd) == (cfg.n_heads, cfg.n_kv_heads, 16)
    assert cfg.frontend_tokens == 8


@pytest.mark.parametrize("with_prefix", [False, True])
def test_embed_matches_jax(models, with_prefix):
    """The tokens' embeddings, with the patches put before them where
    given: (B, P + S_tok, D), the patches unchanged."""
    jcfg, cfg, tree, model = models
    toks = tokens_of(cfg, 0, S_TOK)
    pre = patches_of(cfg, 1) if with_prefix else None
    want = jax_embed(jax.tree.map(jnp.asarray, tree), jcfg,
                     jnp.asarray(toks, jnp.int32),
                     None if pre is None else jnp.asarray(pre))
    with torch.no_grad():
        got = _embed(model, cfg, torch.from_numpy(toks),
                     None if pre is None else torch.from_numpy(pre))
    P = 0 if pre is None else cfg.frontend_tokens
    assert got.shape == (B, P + S_TOK, cfg.d_model)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if pre is not None:
        np.testing.assert_array_equal(got[:, :P].numpy(), pre)


@pytest.mark.parametrize("with_prefix", [False, True])
def test_prefill_matches_jax(models, with_prefix):
    """Logits at every position and every cache entry (the slots past the
    prompt included) against the reference's; the cache's ``len`` and
    its default length are P + S_tok, the patches counted."""
    jcfg, cfg, tree, model = models
    toks = tokens_of(cfg, 2, S_TOK)
    pre = patches_of(cfg, 3) if with_prefix else None
    P = 0 if pre is None else cfg.frontend_tokens
    jparams = jax.tree.map(jnp.asarray, tree)
    for max_len in (None, P + S_TOK + STEPS):
        jl, jc = jax_prefill(jparams, jcfg, jnp.asarray(toks, jnp.int32),
                             max_len=max_len, chunk=16,
                             prefix_embeds=(None if pre is None
                                            else jnp.asarray(pre)))
        tl, tc = prefill(model, cfg, torch.from_numpy(toks),
                         max_len=max_len,
                         prefix_embeds=(None if pre is None
                                        else torch.from_numpy(pre)))
        assert tl.shape == (B, P + S_TOK, 256)
        scaled_close(tl, jl)
        assert set(tc) == set(jc) == {"len", "k", "v"}
        assert tc["k"].shape[2] == (max_len or P + S_TOK)
        for k in jc:
            scaled_close(tc[k], jc[k])
        assert int(tc["len"]) == int(jc["len"]) == P + S_TOK


def test_teacher_forced_decode_after_a_prefixed_prefill(models):
    """8 decode steps fed the same tokens after a prefill of the patches
    and the prompt, logits and caches against the reference's.  A ``len``
    taken from the tokens alone would write step one at slot S_tok, over
    a prompt token's K/V, at RoPE position S_tok instead of P + S_tok."""
    jcfg, cfg, tree, model = models
    P = cfg.frontend_tokens
    toks = tokens_of(cfg, 4, S_TOK + STEPS)
    pre = patches_of(cfg, 5)
    jparams = jax.tree.map(jnp.asarray, tree)
    prompt = jnp.asarray(toks[:, :S_TOK], jnp.int32)
    _, jc = jax_prefill(jparams, jcfg, prompt, max_len=P + S_TOK + STEPS,
                        chunk=16,
                        prefix_embeds=jnp.asarray(pre))
    _, tc = prefill(model, cfg, torch.from_numpy(toks[:, :S_TOK]),
                    max_len=P + S_TOK + STEPS,
                    prefix_embeds=torch.from_numpy(pre))
    before = tc["k"].clone()
    for i in range(STEPS):
        step = toks[:, S_TOK + i:S_TOK + i + 1]
        jl, jc = jax_step(jparams, jcfg, jc, jnp.asarray(step, jnp.int32))
        tl, tc = decode_step(model, cfg, tc, torch.from_numpy(step))
        scaled_close(tl, jl)
        for k in jc:
            scaled_close(tc[k], jc[k])
    assert int(tc["len"]) == int(jc["len"]) == P + S_TOK + STEPS
    # the prompt's K/V (patches and tokens) were never written over
    assert torch.equal(tc["k"][:, :, :P + S_TOK], before[:, :, :P + S_TOK])


def test_decode_matches_prefill(models):
    """tests/test_models_smoke.py's teacher-forcing consistency, on the
    port alone, with the patches before the tokens: decoding token t from
    a cache of the patches and the tokens before it gives the prefill's
    logits at t, and writes its K/V at slot P + t."""
    _, cfg, _, model = models
    P = cfg.frontend_tokens
    toks = torch.from_numpy(tokens_of(cfg, 6, S_TOK))
    pre = torch.from_numpy(patches_of(cfg, 7))
    full, fc = prefill(model, cfg, toks, prefix_embeds=pre)
    _, cache = prefill(model, cfg, toks[:, :-1], max_len=P + S_TOK,
                       prefix_embeds=pre)
    step, cache = decode_step(model, cfg, cache, toks[:, -1:])
    scaled_close(step, full[:, -1])
    scaled_close(cache["k"], fc["k"])
    assert int(cache["len"]) == int(fc["len"]) == P + S_TOK


def test_int8_decode_matches_jax(models):
    """16 decode steps through an int8 cache of P + 4 + 12 slots whose
    first P + 4 hold the reference's prefill (the patches and 4 tokens)
    quantized by the reference's ``_quant_kv``, a step at a time from the
    reference's own cache: logits within TOL, the new slot's codes within
    1 and every other code equal; the last 4 steps run past a full cache.
    Then the reference's contract: the int8 logits within 2% of the
    float cache's over the same steps."""
    jcfg, cfg, tree, model = models
    P, S0, T = cfg.frontend_tokens, 4, 16
    S_max = P + S0 + 12
    toks = tokens_of(cfg, 8, S0 + T)
    pre = patches_of(cfg, 9)
    jparams = jax.tree.map(jnp.asarray, tree)
    _, jf = jax_prefill(jparams, jcfg, jnp.asarray(toks[:, :S0], jnp.int32),
                        max_len=S_max, chunk=16,
                        prefix_embeds=jnp.asarray(pre))
    jc = {k: np.array(v) for k, v in jax_init_cache(
        jparams, jcfg, B, S_max, kv_dtype="int8").items()}
    assert set(jc) == {"len", "k", "v", "ks", "vs"}
    for n in ("k", "v"):
        codes, scales = jax_quant_kv(jf[n][:, :, :P + S0])
        jc[n][:, :, :P + S0] = np.asarray(codes)
        jc[n + "s"][:, :, :P + S0] = np.asarray(scales)
    jc["len"] = np.asarray(jf["len"])
    start = {k: v.copy() for k, v in jc.items()}
    tc0 = init_cache(model, cfg, B, S_max, kv_dtype="int8")
    assert {k: (v.dtype, tuple(v.shape)) for k, v in tc0.items()} == {
        k: (torch.from_numpy(np.array(v)).dtype, v.shape)
        for k, v in jc.items()}
    flips = 0
    for t in range(T):
        step = toks[:, S0 + t:S0 + t + 1]
        tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
        tl, tc = decode_step(model, cfg, tc, torch.from_numpy(step))
        jl, jc = jax_step(jparams, jcfg,
                          {k: jnp.asarray(v) for k, v in jc.items()},
                          jnp.asarray(step, jnp.int32))
        jc = {k: np.asarray(v) for k, v in jc.items()}
        scaled_close(tl, jl)
        slot = min(P + S0 + t, S_max - 1)
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
        for t in range(T):
            step = torch.from_numpy(toks[:, S0 + t:S0 + t + 1])
            logits, cache = decode_step(model, cfg, cache, step)
        return logits

    _, fcache = prefill(model, cfg, torch.from_numpy(toks[:, :S0]),
                        max_len=S_max, prefix_embeds=torch.from_numpy(pre))
    lb = decode_all(fcache)
    lq = decode_all({k: torch.from_numpy(v) for k, v in start.items()})
    rel = float((lq - lb).abs().max() / (lb.abs().max() + 1e-9))
    assert rel < INT8_RTOL, rel


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_padded_prefill_and_decode_match_jax(variant):
    """The VLM at tp 16 with pad_kv, at the heads ``padded_heads`` gives
    (reduced: 16 over 1, MQA's one KV head kept; G 8: 16 over 16): the
    reference's padded tree loads strictly, and a prefixed prefill and 4
    teacher-forced decode steps match the reference's."""
    jcfg, cfg, tree, model = load(variant, tp=16, pad_kv=True)
    H, K = cfg.padded_heads(16, True)
    dims = dims_from_params(model, cfg)
    assert (dims.H, dims.K) == (H, K) == (16, 1 if variant == "reduced"
                                          else 16)
    P, n = cfg.frontend_tokens, 4
    toks = tokens_of(cfg, 10, S_TOK + n)
    pre = patches_of(cfg, 11)
    jparams = jax.tree.map(jnp.asarray, tree)
    prompt = jnp.asarray(toks[:, :S_TOK], jnp.int32)
    jl, jc = jax_prefill(jparams, jcfg, prompt, max_len=P + S_TOK + n,
                         chunk=16,
                         prefix_embeds=jnp.asarray(pre))
    tl, tc = prefill(model, cfg, torch.from_numpy(toks[:, :S_TOK]),
                     max_len=P + S_TOK + n,
                     prefix_embeds=torch.from_numpy(pre))
    scaled_close(tl, jl)
    assert tc["k"].shape[-2:] == (K, cfg.hd)
    for k in jc:
        scaled_close(tc[k], jc[k])
    for i in range(n):
        step = toks[:, S_TOK + i:S_TOK + i + 1]
        jl, jc = jax_step(jparams, jcfg, jc, jnp.asarray(step, jnp.int32))
        tl, tc = decode_step(model, cfg, tc, torch.from_numpy(step))
        scaled_close(tl, jl)
        for k in jc:
            scaled_close(tc[k], jc[k])


def make_batch(cfg, seed):
    """tests/test_models_smoke.py::make_batch's shape: tokens and labels
    of S_tok, the patches before them; numpy-seeded."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size,
                                   (B, S_TOK)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size,
                                   (B, S_TOK)).astype(np.int32),
            "prefix_embeds": patches_of(cfg, seed + 1)}


def test_forward_train_matches_jax(models):
    """forward_train's loss (the P patch positions' logits cut off before
    the cross-entropy) and every parameter's gradient against
    ``jax.value_and_grad`` of the reference's, within
    tests/test_torch_train.py's bound."""
    jcfg, cfg, tree, model = models
    batch = make_batch(cfg, 12)
    jloss, jgrads = jax.value_and_grad(lambda p: jax_forward_train(
        p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}))(
        jax.tree.map(jnp.asarray, tree))
    named = dict(model.named_parameters())
    tb = tloop.batch_to(batch, "cpu")
    assert tb["prefix_embeds"].dtype == torch.float32
    loss = forward_train(model, cfg, tb)
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


def test_make_prefill_step_matches_jax(models):
    """make_prefill_step passes the batch's patches on: the last
    position's logits and the cache against the reference's step."""
    jcfg, cfg, tree, model = models
    P = cfg.frontend_tokens
    batch = make_batch(cfg, 13)
    jl, jc = jax_make_prefill_step(jcfg, max_len=P + S_TOK + 4, chunk=16)(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tc = make_prefill_step(cfg, max_len=P + S_TOK + 4)(
        model, tloop.batch_to(batch, "cpu"))
    assert tl.shape == (B, 256)
    scaled_close(tl, jl)
    for k in jc:
        scaled_close(tc[k], jc[k])
    assert int(tc["len"]) == P + S_TOK


def test_prefill_takes_a_prefix_in_any_family():
    """The reference's ``_embed`` takes ``prefix_embeds`` for every family:
    reduced stablelm-3b with 4 prefix embeddings matches the reference;
    the audio family still needs its frames, a prefix is not frames."""
    jcfg = jax_reduced(jax_get_config("stablelm-3b"))
    cfg = reduced(get_config("stablelm-3b"))
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    model = init_params(cfg, 1)
    model.load_state_dict(params_from_jax(tree), strict=True)
    toks = tokens_of(cfg, 14, S_TOK)
    pre = np.random.default_rng(15).standard_normal(
        (B, 4, cfg.d_model)).astype(np.float32)
    jl, jc = jax_prefill(jax.tree.map(jnp.asarray, tree), jcfg,
                         jnp.asarray(toks, jnp.int32), chunk=16,
                         prefix_embeds=jnp.asarray(pre))
    tl, tc = prefill(model, cfg, torch.from_numpy(toks),
                     prefix_embeds=torch.from_numpy(pre))
    scaled_close(tl, jl)
    for k in jc:
        scaled_close(tc[k], jc[k])
    acfg = reduced(get_config("seamless-m4t-large-v2"))
    with pytest.raises(ValueError, match="needs enc_frames"):
        prefill(init_params(acfg, 0), acfg, torch.from_numpy(toks),
                prefix_embeds=torch.zeros((B, 4, acfg.d_model)))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_serve_on_cpu_gives_the_reference_tokens(variant):
    """The launcher on the reference's weights against the reference's
    ``prefill(prefix_embeds=)`` and greedy ``decode_step`` on the same
    prompts and patches (drawn, as the launcher draws them, from the
    seed's generator: the prompts, then the patches): the same tokens and
    logits, the page pool holding token pages only, and no kernel
    launched on the CPU."""
    R, S, G, SP, seed = 3, 24, 5, 16, 2
    jcfg, cfg, tree, model = load(variant)
    P = cfg.frontend_tokens
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, cfg.vocab_size, SP, dtype=np.int32)
    prompts = np.concatenate(
        [np.tile(shared, (R, 1)),
         rng.integers(1, cfg.vocab_size, (R, S - SP), dtype=np.int32)],
        axis=1)
    patches = rng.standard_normal((R, P, cfg.d_model)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    lg, cache = jax_prefill(jparams, jcfg, jnp.asarray(prompts),
                            max_len=P + S + G, chunk=64,
                            prefix_embeds=jnp.asarray(patches))
    assert int(cache["len"]) == P + S
    lg = lg[:, -1, :cfg.vocab_size]
    want_logits, want = [lg], [jnp.argmax(lg, -1)[:, None]]
    for _ in range(G - 1):
        lg, cache = jax_decode_step(jparams, jcfg, cache,
                                    want[-1].astype(jnp.int32))
        want_logits.append(lg[:, :cfg.vocab_size])
        want.append(jnp.argmax(want_logits[-1], -1)[:, None])

    launches = flash_fwd.launches
    got = serve(device="cpu", params=model, requests=R, prompt_len=S,
                gen_len=G, shared_prefix_len=SP, seed=seed)
    assert got["arch"] == cfg.name
    np.testing.assert_array_equal(
        got["tokens"], np.concatenate([np.asarray(t) for t in want], 1))
    scaled_close(got["logits"], np.stack(want_logits, 1))
    # token pages only: the shared prefix's once, each request's own
    assert got["pool"]["slots_used"] == SP // 8 + R * ((S - SP + G + 7) // 8)
    assert flash_fwd.launches == launches
    assert got["launches"]["flash_fwd"] == {"prefill": 0, "decode": 0}


def test_serve_draws_its_own_weights_and_patches_from_the_seed():
    kw = dict(reduced=True, requests=2, prompt_len=16, gen_len=4,
              shared_prefix_len=8, device="cpu", seed=3)
    a = serve(ARCH, **kw)
    b = serve(ARCH, **kw)
    np.testing.assert_array_equal(a["logits"], b["logits"])
    forced = serve(ARCH, teacher_tokens=a["tokens"], **kw)
    assert np.array_equal(forced["tokens"], a["tokens"])


def test_train_loop_is_finite_and_bitwise_on_a_rerun(monkeypatch):
    """A reduced VLM ``train_loop`` of 3 steps: every batch reaches the
    step with its patches as float32 and its tokens as int64, every loss
    is finite, and a rerun gives the same losses bit for bit."""
    _, cfg = configs("reduced")
    seen = []
    make = tloop.make_train_step

    def spy(*args, **kw):
        step, opt = make(*args, **kw)

        def wrapped(params, state, batch):
            seen.append({k: v.dtype for k, v in batch.items()})
            return step(params, state, batch)
        return wrapped, opt

    monkeypatch.setattr(tloop, "make_train_step", spy)
    kw = dict(steps=3, batch=2, seq_len=8 + S_TOK, device="cpu", seed=4)
    a = tloop.train_loop(cfg, **kw)
    b = tloop.train_loop(cfg, **kw)
    assert seen[0] == {"tokens": torch.int64, "labels": torch.int64,
                       "prefix_embeds": torch.float32}
    assert len(a.losses) == 3 and np.all(np.isfinite(a.losses))
    assert a.losses == b.losses


def test_batch_to_keeps_float_keys_float():
    batch = SyntheticTokens(reduced(get_config(ARCH)), 2, 20).batch_at(0)
    got = tloop.batch_to(batch, "cpu")
    assert {k: v.dtype for k, v in got.items()} == {
        "tokens": torch.int64, "labels": torch.int64,
        "prefix_embeds": torch.float32}
    np.testing.assert_array_equal(got["prefix_embeds"].numpy(),
                                  batch["prefix_embeds"])

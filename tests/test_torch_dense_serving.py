"""The port's dense serving path (stablelm-3b, deepseek-coder-33b,
granite-20b and phi3-medium-14b, reduced) against the JAX reference:
weights handed over with ``params_from_jax``, prefill logits, every K/V
cache entry and teacher-forced decode on the same tokens, the
launcher's tokens and page pool."""
import dataclasses
import json
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch import serve as jax_serve
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.flash_attention import flash_fwd
from repro_torch.launch.serve import serve
from repro_torch.models import (decode_step, dims_from_params, init_cache,
                                init_params, prefill)
from repro_torch.models.convert import params_from_jax, params_to_jax

TOL = 1e-4   # port vs reference, float32 on the CPU: scaled by max |ref|
B, S = 2, 32

# variant -> (arch, overrides of its reduced config): reduced stablelm-3b
# (4 layers, 4 heads of 16, 4 KV heads), its GQA variant (2 KV heads) and
# a sliding window shorter than the prompt (the cache a ring buffer, the
# prefill's K/V rolled into it); the other dense configs reduced, each
# 4 heads over 1 KV head: deepseek-coder-33b (RoPE theta 1e5),
# granite-20b (MQA in full too) and phi3-medium-14b
VARIANTS = {"mha": ("stablelm-3b", {}),
            "gqa": ("stablelm-3b", {"n_kv_heads": 2}),
            "window": ("stablelm-3b", {"n_kv_heads": 2,
                                       "sliding_window": 8}),
            "deepseek": ("deepseek-coder-33b", {}),
            "granite": ("granite-20b", {}),
            "phi3": ("phi3-medium-14b", {})}


def load(variant, seed=0):
    arch, over = VARIANTS[variant]
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(arch)), **over)
    cfg = dataclasses.replace(reduced(get_config(arch)), **over)
    tree = jax.tree.map(np.asarray,
                        jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    model = init_params(cfg, 1)
    model.load_state_dict(params_from_jax(tree), strict=True)
    return jcfg, cfg, tree, model


@pytest.fixture(scope="module", params=list(VARIANTS))
def models(request):
    return load(request.param)


def scaled_close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * max(1.0, float(np.max(np.abs(want)))), err


def test_params_from_jax_round_trip(models):
    jcfg, cfg, tree, model = models
    back = params_to_jax(params_from_jax(tree))
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert np.array_equal(a, b)
    # the port's own module has exactly the reference's shapes
    fresh = init_params(cfg, 0).state_dict()
    assert {k: tuple(v.shape) for k, v in fresh.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    dims = dims_from_params(model, cfg)
    assert (dims.H, dims.K, dims.hd) == (cfg.n_heads, cfg.n_kv_heads, 16)


def test_prefill_and_teacher_forced_decode_match_jax(models):
    jcfg, cfg, tree, model = models
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S + 4))
    jparams = jax.tree.map(jnp.asarray, tree)
    jl, jc = jax_prefill(jparams, jcfg, jnp.asarray(toks[:, :S], jnp.int32),
                         max_len=S + 4, chunk=16)
    tl, tc = prefill(model, cfg, torch.from_numpy(toks[:, :S]),
                     max_len=S + 4)
    scaled_close(tl, jl)
    assert set(tc) == set(jc) == {"len", "k", "v"}
    for k in jc:   # every K/V entry, the padding or the ring included
        scaled_close(tc[k], jc[k])
    for i in range(4):   # teacher forcing: both fed the same next token
        step = toks[:, S + i:S + i + 1]
        jl, jc = jax_decode_step(jparams, jcfg, jc,
                                 jnp.asarray(step, jnp.int32))
        tl, tc = decode_step(model, cfg, tc, torch.from_numpy(step))
        scaled_close(tl, jl)
        for k in ("k", "v"):
            scaled_close(tc[k], jc[k])
    assert int(tc["len"]) == int(jc["len"]) == S + 4


def test_decode_matches_prefill(models):
    """tests/test_models_smoke.py's teacher-forcing consistency, on the
    port alone: decoding token t from a cache of the tokens before it
    gives the prefill's logits at t."""
    _, cfg, _, model = models
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)))
    full, _ = prefill(model, cfg, toks)
    _, cache = prefill(model, cfg, toks[:, :S - 1], max_len=S)
    step, _ = decode_step(model, cfg, cache, toks[:, S - 1:])
    scaled_close(step, full[:, -1])


def test_dense_cache_needs_its_length():
    _, cfg, _, model = load("mha")
    with pytest.raises(ValueError, match="max_len"):
        init_cache(model, cfg, 2)
    c = init_cache(model, cfg, 2, 40)
    assert c["k"].shape == (cfg.n_layers, 2, 40, cfg.n_kv_heads, 16)


def test_serve_on_cpu_gives_the_reference_tokens(monkeypatch, capsys):
    """The reference launcher's default (stablelm-3b, reduced) on its own
    seed-0 weights, handed to the port: the same greedy tokens and page
    pool, and no kernel launched on the CPU."""
    monkeypatch.setattr(sys, "argv", ["serve", "--reduced"])
    jax_serve.main()
    out = capsys.readouterr().out
    want_pool = {k: int(v) for k, v in re.findall(
        r"(dedup_hits|remote_fetches|slots_used)=(\d+)", out)}
    want_first = json.loads(re.search(r"generated\[0\]: (\[.*\])",
                                      out).group(1))
    _, cfg, _, model = load("mha")
    launches = flash_fwd.launches
    got = serve(reduced=True, device="cpu", params=model)
    assert got["arch"] == "stablelm-3b-smoke"
    assert got["pool"] == want_pool and len(want_pool) == 3
    assert got["tokens"][0].tolist() == want_first
    assert got["logits"].shape == (8, 8, 256)
    assert np.array_equal(got["tokens"], got["logits"].argmax(-1))
    assert flash_fwd.launches == launches   # the CPU runs no kernel
    assert got["launches"]["flash_fwd"] == {"prefill": 0, "decode": 0}


def test_serve_draws_its_own_weights_from_the_seed():
    kw = dict(reduced=True, requests=2, prompt_len=16, gen_len=5,
              shared_prefix_len=8, device="cpu", seed=3)
    a = serve(**kw)
    b = serve(**kw)
    np.testing.assert_array_equal(a["logits"], b["logits"])
    forced = serve(teacher_tokens=a["tokens"], **kw)
    assert np.array_equal(forced["tokens"], a["tokens"])

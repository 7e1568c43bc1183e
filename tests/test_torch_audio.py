"""The port's audio family (seamless-m4t-large-v2, reduced: 2 encoder and
4 decoder layers) against the JAX reference on the same seeded numpy
weights, frames and tokens: the weight round-trip, cross-attention
(``attn_apply`` with ``kv_x``), the encoder, prefill logits and every
cache entry, teacher-forced decode, the errors for missing frames and a
missing ``enc_len``, and the launcher's tokens and page pool against the
reference's ``prefill``/``decode_step`` on the launcher's frames and
prompts.  On the CPU every attention call runs the flash kernel's plain
version."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core.hashring import ChordRing as JaxChordRing
from repro.edgecache import PagePoolManager as JaxPagePoolManager
from repro.models import attention as jattn
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models.model import _dense_block as jax_dense_block
from repro.models.model import model_dims as jax_model_dims
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.flash_attention import flash_fwd
from repro_torch.launch.serve import serve
from repro_torch.models import (decode_step, dims_from_params, encode,
                                init_cache, init_params, prefill)
from repro_torch.models.attention import attn_apply
from repro_torch.models.convert import (params_from_jax, params_to_jax,
                                        reference_leaf)

TOL = 1e-4   # port vs reference, float32 on the CPU: scaled by max |ref|
ARCH = "seamless-m4t-large-v2"
B, S, S_ENC = 2, 32, 40   # S_enc is not the prompt's length
STEPS = 6                 # teacher-forced decode steps

# reduced seamless (4 heads of 16, 4 KV heads) and a GQA variant (2 KV
# heads)
VARIANTS = {"mha": {}, "gqa": {"n_kv_heads": 2}}


def load(variant, seed=0):
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(ARCH)),
                               **VARIANTS[variant])
    cfg = dataclasses.replace(reduced(get_config(ARCH)), **VARIANTS[variant])
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


def frames_of(cfg, seed, n=S_ENC, batch=B):
    return np.random.default_rng(seed).standard_normal(
        (batch, n, cfg.d_model)).astype(np.float32)


def test_params_from_jax_round_trip(models):
    jcfg, cfg, tree, model = models
    assert set(tree) == {"embed", "final_norm", "lm_head", "enc_layers",
                         "layers"}
    assert {"lnx", "xattn"} <= set(tree["layers"])
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
    assert len(model.enc_layers) == 2 and len(model.layers) == 4
    dims = dims_from_params(model, cfg)
    assert (dims.H, dims.K, dims.hd) == (cfg.n_heads, cfg.n_kv_heads, 16)
    # every parameter names its reference leaf and layer
    assert reference_leaf("layers.3.xattn.wk") == ("layers/xattn/wk", 3)
    assert reference_leaf("enc_layers.1.mlp.w_up") == ("enc_layers/mlp/w_up",
                                                       1)
    for name, t in model.state_dict().items():
        key, idx = reference_leaf(name)
        node = tree
        for part in key.split("/"):
            node = node[part]
        want = node if idx is None else node[idx]
        assert np.array_equal(t.numpy(), want), name


@pytest.mark.parametrize("Sq,Skv", [(24, 40), (33, 17)])
def test_cross_attn_apply_matches_jax(models, Sq, Skv):
    """``attn_apply`` with ``kv_x``: K/V from the encoder's output, no
    RoPE on either side, no mask; its k and v are the reference's
    ``proj_kv`` without RoPE, which prefill stores as xk/xv."""
    jcfg, cfg, tree, model = models
    dims = dims_from_params(model, cfg)
    rng = np.random.default_rng(Sq * Skv)
    x = rng.standard_normal((B, Sq, cfg.d_model)).astype(np.float32)
    src = rng.standard_normal((B, Skv, cfg.d_model)).astype(np.float32)
    p = {k: v[1] for k, v in tree["layers"]["xattn"].items()}
    kw = dict(n_heads=dims.H, n_kv=dims.K, hd=dims.hd,
              rope_theta=cfg.rope_theta)
    want = jattn.attn_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                            causal=True, kv_x=jnp.asarray(src), chunk=16,
                            **kw)
    got, k, v = attn_apply({n: torch.from_numpy(np.array(a))
                            for n, a in p.items()},
                           torch.from_numpy(x), causal=True,
                           kv_x=torch.from_numpy(src), **kw)
    scaled_close(got, want)
    scaled_close(k, (src @ p["wk"]).reshape(B, Skv, dims.K, dims.hd))
    scaled_close(v, (src @ p["wv"]).reshape(B, Skv, dims.K, dims.hd))


def test_encoder_matches_jax(models):
    """The encoder: the reference's own block, non-causal, scanned over
    ``enc_layers``; no final norm."""
    jcfg, cfg, tree, model = models
    frames = frames_of(cfg, 3)
    dims = jax_model_dims(jcfg)

    def body(h, lp):
        h, _ = jax_dense_block(lp, h, jcfg, dims, causal=False, chunk=16)
        return h, None

    want, _ = jax.lax.scan(body, jnp.asarray(frames),
                           jax.tree.map(jnp.asarray, tree["enc_layers"]))
    with torch.no_grad():
        got = encode(model, cfg, torch.from_numpy(frames))
    scaled_close(got, want)


def test_prefill_and_teacher_forced_decode_match_jax(models):
    jcfg, cfg, tree, model = models
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (B, S + STEPS))
    frames = frames_of(cfg, 1)
    jparams = jax.tree.map(jnp.asarray, tree)
    jl, jc = jax_prefill(jparams, jcfg, jnp.asarray(toks[:, :S], jnp.int32),
                         max_len=S + STEPS, enc_frames=jnp.asarray(frames),
                         chunk=16)
    tl, tc = prefill(model, cfg, torch.from_numpy(toks[:, :S]),
                     max_len=S + STEPS, enc_frames=torch.from_numpy(frames))
    scaled_close(tl, jl)
    assert set(tc) == set(jc) == {"len", "k", "v", "xk", "xv"}
    assert tc["xk"].shape == (cfg.n_layers, B, S_ENC, cfg.n_kv_heads, 16)
    for k in jc:   # every entry, the self cache's padding included
        scaled_close(tc[k], jc[k])
    for i in range(STEPS):   # teacher forcing: both fed the same token
        step = toks[:, S + i:S + i + 1]
        jl, jc = jax_decode_step(jparams, jcfg, jc,
                                 jnp.asarray(step, jnp.int32))
        tl, tc = decode_step(model, cfg, tc, torch.from_numpy(step))
        scaled_close(tl, jl)
        for k in ("k", "v", "xk", "xv"):
            scaled_close(tc[k], jc[k])
    assert int(tc["len"]) == int(jc["len"]) == S + STEPS


def test_decode_matches_prefill(models):
    """tests/test_models_smoke.py's teacher-forcing consistency, on the
    port alone: decoding token t from a cache of the tokens before it
    (and the same frames) gives the prefill's logits at t."""
    _, cfg, _, model = models
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)))
    frames = torch.from_numpy(frames_of(cfg, 4))
    full, _ = prefill(model, cfg, toks, enc_frames=frames)
    _, cache = prefill(model, cfg, toks[:, :S - 1], max_len=S,
                       enc_frames=frames)
    step, _ = decode_step(model, cfg, cache, toks[:, S - 1:])
    scaled_close(step, full[:, -1])


def test_audio_needs_frames_and_enc_len():
    _, cfg, _, model = load("mha")
    toks = torch.zeros((B, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="needs enc_frames"):
        prefill(model, cfg, toks)
    with pytest.raises(ValueError, match="enc_len"):
        init_cache(model, cfg, B, 16)
    with pytest.raises(ValueError, match="max_len"):
        init_cache(model, cfg, B, enc_len=S_ENC)
    c = init_cache(model, cfg, B, 16, enc_len=S_ENC)
    assert c["xk"].shape == (cfg.n_layers, B, S_ENC, cfg.n_kv_heads, 16)
    assert c["k"].shape == (cfg.n_layers, B, 16, cfg.n_kv_heads, 16)
    # a family without an encoder takes no frames
    dcfg = reduced(get_config("stablelm-3b"))
    with pytest.raises(ValueError, match="takes no enc_frames"):
        prefill(init_params(dcfg, 0), dcfg, toks,
                enc_frames=torch.zeros((B, 4, dcfg.d_model)))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_serve_on_cpu_gives_the_reference_tokens(variant):
    """The launcher on the reference's seed-0 weights against the
    reference's ``prefill`` and greedy ``decode_step`` on the same
    prompts and frames (drawn, as the launcher draws them, from the
    seed's generator: the prompts, then the frames), with the reference
    launcher's page pool beside it: the same tokens, logits and pool,
    and no kernel launched on the CPU."""
    R, P, G, SP, seed = 4, 24, 6, 16, 2
    jcfg, cfg, tree, model = load(variant)
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, cfg.vocab_size, SP, dtype=np.int32)
    prompts = np.concatenate(
        [np.tile(shared, (R, 1)),
         rng.integers(1, cfg.vocab_size, (R, P - SP), dtype=np.int32)],
        axis=1)
    frames = rng.standard_normal((R, P, cfg.d_model)).astype(
        np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    lg, cache = jax_prefill(jparams, jcfg, jnp.asarray(prompts),
                            max_len=P + G, enc_frames=jnp.asarray(frames),
                            chunk=64)
    lg = lg[:, -1, :cfg.vocab_size]
    want_logits, want = [lg], [jnp.argmax(lg, -1)[:, None]]
    for _ in range(G - 1):
        lg, cache = jax_decode_step(jparams, jcfg, cache,
                                    want[-1].astype(jnp.int32))
        want_logits.append(lg[:, :cfg.vocab_size])
        want.append(jnp.argmax(want_logits[-1], -1)[:, None])
    ring = JaxChordRing(virtual_nodes=8)
    for g in range(4):
        ring.add_node(f"g{g}")
    pool = JaxPagePoolManager("g0", 4096, 8, ring)
    for i in range(R):
        pool.register_global(f"req{i}", shared)
        pool.alloc_local(f"req{i}", (P - SP + G + 7) // 8)

    launches = flash_fwd.launches
    got = serve(device="cpu", params=model, requests=R, prompt_len=P,
                gen_len=G, shared_prefix_len=SP, seed=seed)
    assert got["arch"] == cfg.name
    np.testing.assert_array_equal(
        got["tokens"], np.concatenate([np.asarray(t) for t in want], 1))
    scaled_close(got["logits"], np.stack(want_logits, 1))
    assert got["pool"] == {"dedup_hits": pool.stats["dedup_hits"],
                           "remote_fetches": pool.stats["remote_fetch"],
                           "slots_used": pool.used_slots}
    assert flash_fwd.launches == launches   # the CPU runs no kernel
    assert got["launches"]["flash_fwd"] == {"prefill": 0, "decode": 0}


def test_serve_draws_its_own_weights_and_frames_from_the_seed():
    kw = dict(reduced=True, requests=2, prompt_len=16, gen_len=5,
              shared_prefix_len=8, device="cpu", seed=3)
    a = serve(ARCH, **kw)
    b = serve(ARCH, **kw)
    np.testing.assert_array_equal(a["logits"], b["logits"])
    forced = serve(ARCH, teacher_tokens=a["tokens"], **kw)
    assert np.array_equal(forced["tokens"], a["tokens"])

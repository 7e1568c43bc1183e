"""The port's MoE family against the JAX reference on the same seeded
numpy inputs and weights: the router's top-k gating, the capacity, both
dispatches (einsum and sort) with capacity drops, the experts' placement
on the EdgeKV ring and its permutation, reduced mixtral-8x7b (sliding
window shorter than the prompt, so the decode cache's ring wraps) and
reduced arctic-480b (a dense residual FFN beside the experts) through
prefill and teacher-forced decode, and the launcher.  Routing ids must
be exactly equal; values within ``TOL`` scaled.  On the CPU the
attention runs its kernel's plain version."""
import dataclasses
import json
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.edgecache import experts as jexperts
from repro.launch import serve as jax_serve
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import moe as jmoe
from repro.models import prefill as jax_prefill
from repro_torch.configs import get_config, reduced
from repro_torch.edgecache import apply_expert_permutation, expert_placement
from repro_torch.kernels.flash_attention import flash_fwd
from repro_torch.launch.serve import serve
from repro_torch.models import (decode_step, dims_from_params, init_params,
                                prefill)
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_jax, params_to_jax

TOL = 1e-4   # port vs reference, float32 on the CPU: scaled by max |ref|
# the MoE layer alone: G groups of T tokens, E experts, top-k
G, T, D, FF, E, K = 2, 64, 32, 48, 8, 2
CFS = (1.0, 1.25, 8.0)   # 1.0 and 1.25 drop pairs at this routing, 8.0 none
B, S, STEPS = 2, 32, 20  # reduced models: prompt 32 > window 16, 20 steps


def scaled_close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * max(1.0, float(np.max(np.abs(want)))), err


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def moe_layer(activation, dense, seed=0):
    """The reference's MoE weights (numpy) and seeded tokens (G, T, D)."""
    p = jax.tree.map(np.asarray, jmoe.moe_init(
        jax.random.PRNGKey(seed), D, FF, E, activation, jnp.float32,
        dense_ff=40 if dense else 0))
    x = np.random.default_rng(seed).standard_normal((G, T, D)).astype(
        np.float32)
    return p, x


def test_top_k_gating_matches_jax():
    p, x = moe_layer("swiglu", False, seed=3)
    jg, ji, ja = jmoe._top_k_gating(jnp.asarray(x), jnp.asarray(p["router"]),
                                    K)
    tg, ti, ta = tmoe._top_k_gating(torch.from_numpy(x),
                                    to_torch(p["router"]), K)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    scaled_close(tg, jg)
    scaled_close(ta, ja)
    assert ti.shape == (G, T, K)


@pytest.mark.parametrize("tokens", [1, 8, 64, 1024])
@pytest.mark.parametrize("experts,top_k,cf",
                         [(8, 2, 1.0), (8, 2, 1.25), (8, 2, 2.0),
                          (4, 2, 8.0), (128, 2, 1.25), (8, 1, 1.25)])
def test_capacity_matches_jax(tokens, experts, top_k, cf):
    assert (tmoe._capacity(tokens, experts, top_k, cf)
            == jmoe._capacity(tokens, experts, top_k, cf))


def drops(p, x, cf):
    """How many (token, slot) pairs overflow their expert's capacity."""
    ids = np.asarray(jmoe._top_k_gating(jnp.asarray(x),
                                        jnp.asarray(p["router"]), K)[1])
    C = jmoe._capacity(T, E, K, cf)
    per = np.stack([np.bincount(g.reshape(-1), minlength=E) for g in ids])
    return int(np.maximum(per - C, 0).sum())


@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("dense", [False, True], ids=["moe", "dense"])
@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_moe_apply_matches_jax(dispatch, activation, dense, cf):
    p, x = moe_layer(activation, dense)
    assert (drops(p, x, cf) > 0) == (cf < 8.0)
    jy, ja = jmoe.moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                            top_k=K, activation=activation,
                            capacity_factor=cf, dispatch=dispatch)
    ty, ta = tmoe.moe_apply(to_torch(p), torch.from_numpy(x), top_k=K,
                            activation=activation, capacity_factor=cf,
                            dispatch=dispatch)
    assert ty.shape == (G, T, D) and ty.dtype == torch.float32
    scaled_close(ty, jy)
    scaled_close(ta, ja)


@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_port_einsum_equals_port_sort(activation, cf):
    """Both dispatches drop the same pairs: the outputs agree."""
    p, x = moe_layer(activation, True, seed=5)
    kw = dict(top_k=K, activation=activation, capacity_factor=cf)
    ye, ae = tmoe.moe_apply_einsum(to_torch(p), torch.from_numpy(x), **kw)
    ys, as_ = tmoe.moe_apply_sort(to_torch(p), torch.from_numpy(x), **kw)
    scaled_close(ys, ye, 1e-5)
    assert float(ae) == float(as_)


@pytest.mark.parametrize("n_experts,n_shards,weights",
                         [(128, 16, None), (64, 8, None),
                          (64, 8, [4.0] + [1.0] * 7), (8, 4, None),
                          (8, 8, None)])
def test_expert_placement_matches_jax(n_experts, n_shards, weights):
    got = expert_placement(n_experts, n_shards, shard_weights=weights)
    want = jexperts.expert_placement(n_experts, n_shards,
                                     shard_weights=weights)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert sorted(got.tolist()) == list(range(n_experts))
    with pytest.raises(ValueError, match="divide"):
        expert_placement(n_experts + 1, n_shards)


@pytest.mark.parametrize("shapes", [
    {"w_up": (8, 6, 4), "w_down": (8, 4, 6)},     # per layer (E, D, F)
    {"bias": (8, 5)},                              # 2-D (E, ...)
    {"w_up": (3, 8, 6, 4)},                        # stacked (L, E, ...)
    {"w_up": (8, 8, 6, 4)},                        # L == E: the layer axis
], ids=["per-layer", "2d", "stacked", "stacked-L-eq-E"])
def test_apply_expert_permutation_matches_jax(shapes):
    perm = expert_placement(8, 4)
    rng = np.random.default_rng(1)
    w = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    want = jexperts.apply_expert_permutation(
        {k: jnp.asarray(v) for k, v in w.items()}, perm)
    got = apply_expert_permutation(to_torch(w), perm)
    for k in w:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
    nested = apply_expert_permutation({"experts": to_torch(w)}, perm)
    assert all(torch.equal(nested["experts"][k], got[k]) for k in w)


# ------------------------------------------------------- reduced models
def load(arch, seed=0, **over):
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(arch)), **over)
    cfg = dataclasses.replace(reduced(get_config(arch)), **over)
    tree = jax.tree.map(np.asarray,
                        jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    model = init_params(cfg, 1)
    model.load_state_dict(params_from_jax(tree), strict=True)
    return jcfg, cfg, tree, model


@pytest.fixture(scope="module")
def mixtral():
    return load("mixtral-8x7b")


@pytest.fixture(scope="module")
def arctic():
    return load("arctic-480b")


@pytest.mark.parametrize("arch", ["mixtral", "arctic"])
def test_params_from_jax_round_trip(arch, request):
    _, cfg, tree, model = request.getfixturevalue(arch)
    back = params_to_jax(params_from_jax(tree))
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert np.array_equal(a, b)
    # the port's own module has exactly the reference's names and shapes
    fresh = init_params(cfg, 0).state_dict()
    assert {k: tuple(v.shape) for k, v in fresh.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    sd = model.state_dict()
    assert sd["layers.0.moe.experts.w_gate"].shape == (
        cfg.n_experts, cfg.d_model, cfg.d_ff)
    assert ("layers.0.moe.dense.w_up" in sd) == (arch == "arctic")
    dims = dims_from_params(model, cfg)
    assert (dims.H, dims.K, dims.hd) == (cfg.n_heads, cfg.n_kv_heads, 16)


def prefill_and_decode(jcfg, cfg, tree, model, dispatch, steps):
    """Prefill S tokens, then ``steps`` teacher-forced decode steps, on
    both sides; every logit and every cache entry compared."""
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (B, S + steps))
    jparams = jax.tree.map(jnp.asarray, tree)
    jl, jc = jax_prefill(jparams, jcfg, jnp.asarray(toks[:, :S], jnp.int32),
                         max_len=S + steps, dispatch=dispatch, chunk=16)
    tl, tc = prefill(model, cfg, torch.from_numpy(toks[:, :S]),
                     max_len=S + steps, dispatch=dispatch)
    scaled_close(tl, jl)
    assert set(tc) == set(jc) == {"len", "k", "v"}
    for k in jc:   # every K/V entry, the padding or the ring included
        scaled_close(tc[k], jc[k])
    for i in range(steps):   # teacher forcing: both fed the same token
        step = toks[:, S + i:S + i + 1]
        jl, jc = jax_decode_step(jparams, jcfg, jc,
                                 jnp.asarray(step, jnp.int32),
                                 dispatch=dispatch)
        tl, tc = decode_step(model, cfg, tc, torch.from_numpy(step),
                             dispatch=dispatch)
        scaled_close(tl, jl)
        for k in ("k", "v"):
            scaled_close(tc[k], jc[k])
    assert int(tc["len"]) == int(jc["len"]) == S + steps
    return tc


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_mixtral_prefill_and_decode_past_the_window_match_jax(mixtral,
                                                              dispatch):
    """reduced mixtral: 4 layers of 4 experts, top-2, one KV head for 4
    query heads, window 16 under a 32-token prompt (the prefill's K/V
    rolled into a 16-slot ring) and 20 decode steps (the ring wraps)."""
    jcfg, cfg, tree, model = mixtral
    assert (cfg.sliding_window, cfg.n_kv_heads, cfg.n_experts) == (16, 1, 4)
    tc = prefill_and_decode(jcfg, cfg, tree, model, dispatch, STEPS)
    assert tc["k"].shape == (cfg.n_layers, B, 16, 1, 16)


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_arctic_prefill_and_decode_match_jax(arctic, dispatch):
    """reduced arctic-480b: the dense residual FFN beside the experts."""
    jcfg, cfg, tree, model = arctic
    assert cfg.moe_dense_residual and cfg.sliding_window == 0
    prefill_and_decode(jcfg, cfg, tree, model, dispatch, 4)


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_mixtral_with_capacity_drops_matches_jax(monkeypatch, dispatch):
    """mixtral's own 8 experts and capacity factor 1.25: C 10 in prefill
    (32 tokens a group) and 1 in decode (the batch of 2 as one group, cf
    2.0), where this routing drops pairs in both phases."""
    jcfg, cfg, tree, model = load("mixtral-8x7b", n_experts=8,
                                  capacity_factor=1.25)
    seen = []   # (tokens a group, capacity, pairs dropped) per MoE call
    capacity, gating = tmoe._capacity, tmoe._top_k_gating

    def record_gating(x, router, top_k):
        out = gating(x, router, top_k)
        C = seen[-1][1]
        per = F.one_hot(out[1], router.shape[-1]).sum(dim=(1, 2))
        seen[-1] = (x.shape[1], C, int((per - C).clamp(min=0).sum()))
        return out

    def record_capacity(*args):
        seen.append((None, capacity(*args), None))
        return seen[-1][1]

    monkeypatch.setattr(tmoe, "_capacity", record_capacity)
    monkeypatch.setattr(tmoe, "_top_k_gating", record_gating)
    prefill_and_decode(jcfg, cfg, tree, model, dispatch, 4)
    L = cfg.n_layers
    assert [(t, c) for t, c, _ in seen] == [(S, 10)] * L + [(B, 1)] * 4 * L
    assert sum(d for _, _, d in seen[:L]) > 0     # prefill drops
    assert sum(d for _, _, d in seen[L:]) > 0     # decode drops


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_decode_matches_prefill(mixtral, dispatch):
    """Decoding token t from a cache of the tokens before it gives the
    prefill's logits at t, the window's ring included."""
    _, cfg, _, model = mixtral
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)))
    full, _ = prefill(model, cfg, toks, dispatch=dispatch)
    _, cache = prefill(model, cfg, toks[:, :S - 1], max_len=S,
                       dispatch=dispatch)
    step, _ = decode_step(model, cfg, cache, toks[:, S - 1:],
                          dispatch=dispatch)
    scaled_close(step, full[:, -1])


def test_serve_on_cpu_gives_the_reference_tokens(monkeypatch, capsys):
    """The reference launcher on reduced mixtral and its own seed-0
    weights, handed to the port: the same greedy tokens and page pool,
    and no kernel launched on the CPU."""
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "mixtral-8x7b",
                                      "--reduced"])
    jax_serve.main()
    out = capsys.readouterr().out
    want_pool = {k: int(v) for k, v in re.findall(
        r"(dedup_hits|remote_fetches|slots_used)=(\d+)", out)}
    want_first = json.loads(re.search(r"generated\[0\]: (\[.*\])",
                                      out).group(1))
    _, _, _, model = load("mixtral-8x7b")
    before = flash_fwd.launches
    got = serve(reduced=True, device="cpu", params=model)
    assert got["arch"] == "mixtral-8x7b-smoke"
    assert got["pool"] == want_pool and len(want_pool) == 3
    assert got["tokens"][0].tolist() == want_first
    assert got["logits"].shape == (8, 8, 256)
    assert np.isfinite(got["logits"]).all()
    assert np.array_equal(got["tokens"], got["logits"].argmax(-1))
    assert flash_fwd.launches == before
    # and with its own weights, drawn from the seed
    own = serve("mixtral-8x7b", reduced=True, device="cpu")
    assert own["pool"] == want_pool
    assert np.array_equal(own["tokens"], own["logits"].argmax(-1))

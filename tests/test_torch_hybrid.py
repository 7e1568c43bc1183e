"""The port's hybrid family (zamba2-1.2b: Mamba2 layers and one shared
attention block) against the JAX reference on the same seeded numpy
inputs and weights: the causal conv, the Mamba2 mixer in prefill and
decode, reduced zamba2 at 4 layers and at 5 (two full groups and a tail
layer with no shared block) through prefill and teacher-forced decode,
and the launcher's tokens and page pool.  On the CPU the SSD scan and
the attention run their plain versions."""
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
from repro.models import ssm as jssm
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.flash_attention import flash_fwd
from repro_torch.kernels.ssm_scan import ssm_scan_kernel
from repro_torch.launch.serve import serve
from repro_torch.models import (decode_step, dims_from_params, init_cache,
                                init_params, prefill)
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import params_from_jax, params_to_jax

TOL = 1e-4   # port vs reference, float32 on the CPU: scaled by max |ref|
B, S = 2, 32
# Mamba2 alone: d_model 32, expand 2 (two heads of 64), N 16, conv 4
D, EXPAND, N, CONV = 32, 2, 16, 4


def scaled_close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * max(1.0, float(np.max(np.abs(want)))), err


def t(a):
    return torch.from_numpy(np.array(a))


def mamba_params(seed, dt_bias=0.0):
    """The reference's Mamba2 weights (numpy), with a random A_log and
    D so that the decays and the skip differ between heads."""
    p = jax.tree.map(np.asarray, jssm.mamba2_init(
        jax.random.PRNGKey(seed), D, expand=EXPAND, d_state=N, conv_k=CONV))
    rng = np.random.default_rng(seed)
    nh = p["A_log"].shape[0]
    p = dict(p, A_log=rng.uniform(-1.0, 0.5, nh).astype(np.float32),
             D=rng.standard_normal(nh).astype(np.float32),
             dt_bias=np.full(nh, dt_bias, np.float32))
    return p, {k: t(v) for k, v in p.items()}


def mamba_state(kind, seed):
    """None, zeros or a random {"conv", "ssm"} state, as numpy."""
    if kind == "none":
        return None
    d_in = EXPAND * D
    rng = np.random.default_rng(seed)
    shapes = {"conv": (B, CONV - 1, d_in + 2 * N),
              "ssm": (B, d_in // 64, N, 64)}
    return {k: (np.zeros(s, np.float32) if kind == "zero" else
                rng.standard_normal(s).astype(np.float32))
            for k, s in shapes.items()}


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(7)
    C = 40
    x = rng.standard_normal((B, 9, C)).astype(np.float32)
    w = rng.standard_normal((CONV, C)).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    st = (rng.standard_normal((B, CONV - 1, C)).astype(np.float32)
          if with_state else None)
    jy, js = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b),
                               None if st is None else jnp.asarray(st))
    ty, ts = tssm._causal_conv(t(x), t(w), t(b),
                               None if st is None else t(st))
    scaled_close(ty, jy)
    scaled_close(ts, js)
    # the state is the last K-1 inputs: one step at a time gives the same
    steps, state = [], None if st is None else t(st)
    for i in range(x.shape[1]):
        y, state = tssm._causal_conv(t(x[:, i:i + 1]), t(w), t(b), state)
        steps.append(y)
    scaled_close(torch.cat(steps, dim=1), jy)


# (initial state, dt_bias): from none, from a zero state (as prefill
# passes it), from a random state, and a dt_bias past softplus's
# threshold of 20, where F.softplus returns x and jax.nn.softplus
# logaddexp(x, 0) (the decay then 25 nats and more a token)
@pytest.mark.parametrize("kind,dt_bias", [("none", 0.0), ("zero", 0.0),
                                          ("random", 0.0), ("random", 25.0)])
def test_mamba2_prefill_matches_jax(kind, dt_bias):
    jp, tp = mamba_params(3, dt_bias)
    u = np.random.default_rng(4).standard_normal((B, S, D)).astype(
        np.float32)
    st = mamba_state(kind, 5)
    kw = dict(expand=EXPAND, d_state=N)
    jy, jst = jssm.mamba2_apply(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(u), chunk=8,
        state=None if st is None else jax.tree.map(jnp.asarray, st), **kw)
    ty, tst = tssm.mamba2_apply(
        tp, t(u), chunk=8, state=None if st is None else
        {k: t(v) for k, v in st.items()}, **kw)
    scaled_close(ty, jy)
    if st is None:
        assert tst is None and jst is None
    else:
        assert set(tst) == set(jst) == {"conv", "ssm"}
        for k in jst:
            scaled_close(tst[k], jst[k])


def test_mamba2_decode_step_matches_jax():
    jp, tp = mamba_params(6)
    st = mamba_state("random", 8)
    u = np.random.default_rng(9).standard_normal((B, 1, D)).astype(
        np.float32)
    kw = dict(expand=EXPAND, d_state=N)
    jy, jst = jssm.mamba2_apply(jax.tree.map(jnp.asarray, jp),
                                jnp.asarray(u),
                                state=jax.tree.map(jnp.asarray, st), **kw)
    ty, tst = tssm.mamba2_apply(tp, t(u), state={k: t(v)
                                                 for k, v in st.items()},
                                **kw)
    scaled_close(ty, jy)
    for k in ("conv", "ssm"):
        scaled_close(tst[k], jst[k])


def test_mamba2_sequence_must_divide_into_chunks():
    _, tp = mamba_params(1)
    u = torch.zeros((1, 200, D))
    with pytest.raises(ValueError, match="divisible"):
        tssm.mamba2_apply(tp, u, expand=EXPAND, d_state=N)   # Q = 128


def load(n_layers, seed=0):
    """Reduced zamba2 (4 Mamba2 layers of d_model 64, two heads of 64,
    N 16; the shared block after every 2, 4 heads of 16) at ``n_layers``:
    the reference's weights handed to the port."""
    jcfg = dataclasses.replace(jax_reduced(jax_get_config("zamba2-1.2b")),
                               n_layers=n_layers)
    cfg = dataclasses.replace(reduced(get_config("zamba2-1.2b")),
                              n_layers=n_layers)
    tree = jax.tree.map(np.asarray,
                        jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    model = init_params(cfg, 1)
    model.load_state_dict(params_from_jax(tree), strict=True)
    return jcfg, cfg, tree, model


# 4 layers: two groups of 2, each followed by the shared block; 5: the
# same and a tail layer with no shared block after it
@pytest.fixture(scope="module", params=[4, 5], ids=["4_layers",
                                                    "5_layers_tail"])
def models(request):
    return load(request.param)


def test_params_from_jax_round_trip(models):
    jcfg, cfg, tree, model = models
    assert set(tree) == {"embed", "final_norm", "lm_head", "layers",
                         "shared_attn"}
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
    assert len(model.layers) == cfg.n_layers
    dims = dims_from_params(model, cfg)
    assert (dims.H, dims.K, dims.hd) == (4, 4, 16)


def test_prefill_and_teacher_forced_decode_match_jax(models):
    jcfg, cfg, tree, model = models
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S + 4))
    jparams = jax.tree.map(jnp.asarray, tree)
    jl, jc = jax_prefill(jparams, jcfg, jnp.asarray(toks[:, :S], jnp.int32),
                         max_len=S + 4, chunk=16)
    tl, tc = prefill(model, cfg, torch.from_numpy(toks[:, :S]),
                     max_len=S + 4)
    scaled_close(tl, jl)
    assert set(tc) == set(jc) == {"len", "conv", "ssm", "ak", "av"}
    assert tc["ak"].shape[0] == cfg.n_layers // cfg.shared_attn_every
    for k in jc:   # every state and K/V entry, the padding included
        scaled_close(tc[k], jc[k])
    for i in range(4):   # teacher forcing: both fed the same next token
        step = toks[:, S + i:S + i + 1]
        jl, jc = jax_decode_step(jparams, jcfg, jc,
                                 jnp.asarray(step, jnp.int32))
        tl, tc = decode_step(model, cfg, tc, torch.from_numpy(step))
        scaled_close(tl, jl)
        for k in jc:
            scaled_close(tc[k], jc[k])
    assert int(tc["len"]) == int(jc["len"]) == S + 4


def test_decode_matches_prefill(models):
    """tests/test_models_smoke.py's teacher-forcing consistency, on the
    port alone: decoding token t from a cache of the tokens before it
    gives the prefill's logits at t."""
    _, cfg, _, model = models
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S + 1)))
    full, _ = prefill(model, cfg, toks)
    _, cache = prefill(model, cfg, toks[:, :S], max_len=S + 1)
    step, _ = decode_step(model, cfg, cache, toks[:, S:])
    scaled_close(step, full[:, -1])


def test_hybrid_cache_shapes_and_length():
    _, cfg, _, model = load(5)
    with pytest.raises(ValueError, match="max_len"):
        init_cache(model, cfg, 3)
    c = init_cache(model, cfg, 3, 40)
    assert c["conv"].shape == (5, 3, 3, 128 + 2 * 16)
    assert c["ssm"].shape == (5, 3, 2, 16, 64)
    assert c["ak"].shape == c["av"].shape == (2, 3, 40, 4, 16)
    assert c["len"].dtype == torch.int32


def test_serve_on_cpu_gives_the_reference_tokens(monkeypatch, capsys):
    """The reference launcher on reduced zamba2 and its own seed-0
    weights, handed to the port: the same greedy tokens and page pool,
    and no kernel launched on the CPU."""
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "zamba2-1.2b",
                                      "--reduced"])
    jax_serve.main()
    out = capsys.readouterr().out
    want_pool = {k: int(v) for k, v in re.findall(
        r"(dedup_hits|remote_fetches|slots_used)=(\d+)", out)}
    want_first = json.loads(re.search(r"generated\[0\]: (\[.*\])",
                                      out).group(1))
    _, _, _, model = load(4)
    before = (flash_fwd.launches, ssm_scan_kernel.launches)
    got = serve(reduced=True, device="cpu", params=model)
    assert got["arch"] == "zamba2-1.2b-smoke"
    assert got["pool"] == want_pool and len(want_pool) == 3
    assert got["tokens"][0].tolist() == want_first
    assert got["logits"].shape == (8, 8, 256)
    assert np.isfinite(got["logits"]).all()
    assert np.array_equal(got["tokens"], got["logits"].argmax(-1))
    assert (flash_fwd.launches, ssm_scan_kernel.launches) == before
    assert got["launches"] == {n: {"prefill": 0, "decode": 0}
                               for n in ("flash_fwd", "ssd_chunked")}
    # and with its own weights, drawn from the seed
    own = serve("zamba2-1.2b", reduced=True, device="cpu")
    assert own["pool"] == want_pool
    assert np.array_equal(own["tokens"], own["logits"].argmax(-1))

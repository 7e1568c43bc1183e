"""The port's training stack against the JAX reference on the same seeded
numpy inputs and weights (handed over with ``params_from_jax``): the
cross-entropy loss, the attention gradient of ``FlashAttention``,
``forward_train``'s loss and every parameter's gradient for reduced
stablelm-3b, granite-20b (MQA) and mixtral-8x7b (both dispatches, the
load-balancing loss included), the optimizers, the schedule, the
clipping and the data pipeline.  On the CPU the attention's forward runs
its kernel's plain version; its backward is the same torch ops on either
device."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.data.pipeline import SyntheticTokens as JaxSyntheticTokens
from repro.models import forward_train as jax_forward_train
from repro.models import init_params as jax_init_params
from repro.models import layers as jlayers
from repro.models.attention import gqa_attention as jax_gqa_attention
from repro.models.model import param_count_tree as jax_param_count_tree
from repro import optim as joptim
from repro_torch import optim as toptim
from repro_torch.configs import get_config, reduced
from repro_torch.data import SyntheticTokens, make_batch_iterator
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import (forward_train, init_params,
                                param_count_tree)
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.layers import cross_entropy_loss
from repro_torch.train import make_train_step

# port vs reference, float32 on the CPU: max |port - ref| <= TOL x max
# |ref|, per tensor (sums over up to a few thousand terms in another order)
TOL = 1e-5
B, S = 2, 32


def scaled_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-30))


def load(arch, seed=0, **over):
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(arch)), **over)
    cfg = dataclasses.replace(reduced(get_config(arch)), **over)
    tree = jax.tree.map(np.asarray,
                        jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    model = init_params(cfg, 1)
    model.load_state_dict(params_from_jax(tree), strict=True)
    return jcfg, cfg, tree, model


def batch_of(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, vocab, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


# ------------------------------------------------------------------ loss
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_loss_matches_jax(masked):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((B, S, 300)) * 4).astype(np.float32)
    labels = rng.integers(0, 256, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.6).astype(np.float32) if masked else None
    want = jlayers.cross_entropy_loss(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    got = cross_entropy_loss(torch.from_numpy(logits),
                             torch.from_numpy(labels),
                             None if mask is None else torch.from_numpy(mask))
    assert scaled_err(got, want) <= TOL
    if masked:       # an all-zero mask divides by one, not by zero
        zero = cross_entropy_loss(torch.from_numpy(logits),
                                  torch.from_numpy(labels),
                                  torch.zeros((B, S)))
        assert float(zero) == 0.0


# ----------------------------------------------------- attention gradient
# (query heads, KV heads, causal, window): MHA causal, a window that binds,
# G = 4 and MQA, and bidirectional
ATTN_CASES = {"causal": (4, 4, True, 0), "window": (4, 2, True, 8),
              "gqa4": (8, 2, True, 0), "mqa": (4, 1, True, 0),
              "bidirectional": (4, 2, False, 0)}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_flash_attention_gradient_matches_jax(case):
    H, K, causal, window = ATTN_CASES[case]
    hd, Sq = 16, 40
    rng = np.random.default_rng(11)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, Sq, K, hd)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b, c: jax_gqa_attention(
        a, b, c, causal=causal, window=window, chunk=16), q, k, v)
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert scaled_err(o.detach(), out) <= TOL
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for name, g, w in zip("qkv", got, want):
        assert scaled_err(g, w) <= TOL, (case, name)


def test_flash_attention_without_grad_builds_no_graph():
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    with torch.no_grad():
        o = flash_attention(q, q.detach(), q.detach())
    assert o.grad_fn is None and not o.requires_grad


# ---------------------------------------------------------- forward_train
# (arch, config overrides, dispatch): stablelm-3b (4 heads over 4), its
# MQA sibling granite-20b (1 KV head), mixtral-8x7b under both dispatches
# at a capacity that drops pairs, so the aux and the drops both count
TRAIN_CASES = {
    "stablelm-3b": ("stablelm-3b", {}, "einsum"),
    "granite-20b": ("granite-20b", {}, "einsum"),
    "mixtral-einsum": ("mixtral-8x7b", {"capacity_factor": 1.0}, "einsum"),
    "mixtral-sort": ("mixtral-8x7b", {"capacity_factor": 1.0}, "sort"),
}


@pytest.fixture(scope="module", params=list(TRAIN_CASES))
def trained(request):
    arch, over, dispatch = TRAIN_CASES[request.param]
    jcfg, cfg, tree, model = load(arch, **over)
    batch = batch_of(cfg.vocab_size)
    jloss, jgrads = jax.value_and_grad(lambda p: jax_forward_train(
        p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
        dispatch=dispatch))(jax.tree.map(jnp.asarray, tree))
    tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    return dict(cfg=cfg, model=model, batch=tbatch, dispatch=dispatch,
                jloss=float(jloss), jgrads=jax.tree.map(np.asarray, jgrads),
                tree=tree, jcfg=jcfg)


def port_grads(t, remat):
    named = dict(t["model"].named_parameters())
    loss = forward_train(t["model"], t["cfg"], t["batch"],
                         dispatch=t["dispatch"], remat=remat)
    grads = torch.autograd.grad(loss, list(named.values()),
                                allow_unused=True)
    return loss.detach(), dict(zip(named, grads))


def test_forward_train_loss_and_every_gradient_match_jax(trained):
    loss, grads = port_grads(trained, remat=False)
    assert abs(float(loss) - trained["jloss"]) <= TOL * abs(trained["jloss"])
    missing = [n for n, g in grads.items() if g is None]
    assert not missing, missing
    got = jax.tree_util.tree_flatten_with_path(params_to_jax(grads))[0]
    want = jax.tree_util.tree_flatten_with_path(trained["jgrads"])[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert scaled_err(g, w) <= TOL, jax.tree_util.keystr(path)


def test_forward_train_remat_equals_no_remat(trained):
    loss, grads = port_grads(trained, remat=False)
    loss_r, grads_r = port_grads(trained, remat=True)
    assert torch.equal(loss, loss_r)
    for name in grads:
        assert torch.equal(grads[name], grads_r[name]), name


def test_moe_aux_enters_the_loss():
    """mixtral's loss is the cross-entropy plus 0.01 x the layers' summed
    load-balancing loss, as the reference's."""
    jcfg, cfg, tree, model = load("mixtral-8x7b")
    batch = batch_of(cfg.vocab_size, seed=4)
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    with torch.no_grad():
        loss = float(forward_train(model, cfg, tb))
        x = model.embed[tb["tokens"]]
        aux = 0.0
        for layer in model.layers:
            x, out = layer(x)
            aux += float(out["aux"])
        from repro_torch.models.model import _logits
        ce = float(cross_entropy_loss(_logits(model, cfg, x), tb["labels"]))
    assert aux > 0
    assert loss == pytest.approx(ce + 0.01 * aux, rel=1e-6)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-125m"])
def test_forward_train_hybrid_and_ssm_raise(arch):
    cfg = reduced(get_config(arch))
    batch = {k: torch.from_numpy(v).long()
             for k, v in batch_of(cfg.vocab_size).items()}
    with pytest.raises(NotImplementedError, match="section 1 item 5"):
        forward_train(init_params(cfg, 0), cfg, batch)


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2"])
def test_forward_train_unported_families_raise(arch):
    """The audio family (served, its training not ported) raises before
    any weight is read."""
    with pytest.raises(NotImplementedError, match="section 1 item 5"):
        forward_train(None, reduced(get_config(arch)), {})


def test_param_count_tree_matches_jax():
    for arch in ("stablelm-3b", "mixtral-8x7b", "granite-20b"):
        _, cfg, tree, model = load(arch)
        assert param_count_tree(model) == jax_param_count_tree(tree)


# -------------------------------------------------------------- optimizers
OPT_STEPS = 5


def opt_pairs():
    sched = dict(peak_lr=1e-2, warmup=2, total=6)
    return {
        "adamw": (joptim.adamw(3e-3), toptim.adamw(3e-3)),
        "adamw-cosine": (
            joptim.adamw(joptim.cosine_schedule(**sched), weight_decay=0.2),
            toptim.adamw(toptim.cosine_schedule(**sched), weight_decay=0.2)),
        "adafactor": (joptim.adafactor(1e-2), toptim.adafactor(1e-2)),
        "adafactor-cosine": (joptim.adafactor(joptim.cosine_schedule(**sched)),
                             toptim.adafactor(toptim.cosine_schedule(**sched))),
        "for_arch-small": (joptim.for_arch(3e9), toptim.for_arch(3e9)),
        "for_arch-large": (joptim.for_arch(30e9), toptim.for_arch(30e9)),
    }


@pytest.mark.parametrize("name", list(opt_pairs()))
def test_optimizer_matches_jax_over_steps(name):
    """The same gradients (numpy, a new draw each step, clipped by both
    packages' global norm) into the reference's optimizer and the port's,
    on reduced mixtral-8x7b's parameters: every parameter and every moment
    after each of 5 steps.  Adafactor sees the reference's stacked
    layout, so its 1-d stacked weights are factored and its RMS clip is
    taken over each stack."""
    jopt, topt = opt_pairs()[name]
    _, _, tree, model = load("mixtral-8x7b")
    jp = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jp)
    named = dict(model.named_parameters())
    tstate = topt.init(named)
    rng = np.random.default_rng(7)
    for _ in range(OPT_STEPS):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32) * 0.3, tree)
        jg, jn = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                            1.0)
        tg, tn = toptim.clip_by_global_norm(params_from_jax(g), 1.0)
        assert scaled_err(tn, jn) <= TOL
        jp, jstate = jopt.update(jg, jstate, jp)
        with torch.no_grad():
            _, tstate = topt.update(tg, tstate, named)
        assert int(tstate["count"]) == int(jstate["count"])
        got = params_to_jax({n: p.detach() for n, p in named.items()})
        for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                jax.tree.leaves(jp)):
            assert scaled_err(a, b) <= TOL, (name, jax.tree_util.keystr(path))
    if "m" in tstate:
        for key in ("m", "v"):
            got = params_to_jax(tstate[key])
            for a, b in zip(jax.tree.leaves(got),
                            jax.tree.leaves(jstate[key])):
                assert scaled_err(a, b) <= TOL
    else:
        flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path): np.asarray(leaf)
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                    jstate["f"])[0]}
        for key, s in tstate["f"].items():
            for part, t in s.items():
                assert scaled_err(t, flat[f"{key}/{part}"]) <= TOL


def test_clip_by_global_norm_scales_only_above_the_bound():
    rng = np.random.default_rng(2)
    g = {"a": rng.standard_normal((4, 5)).astype(np.float32),
         "b": rng.standard_normal(7).astype(np.float32)}
    for bound in (0.5, 100.0):
        jg, jn = joptim.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in g.items()}, bound)
        tg, tn = toptim.clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in g.items()}, bound)
        assert scaled_err(tn, jn) <= TOL
        for k in g:
            assert scaled_err(tg[k], jg[k]) <= TOL
    assert torch.equal(tg["a"], torch.from_numpy(g["a"]))   # unclipped


def test_cosine_schedule_matches_jax():
    jlr = joptim.cosine_schedule(3e-4, warmup=10, total=100, floor_frac=0.1)
    tlr = toptim.cosine_schedule(3e-4, warmup=10, total=100, floor_frac=0.1)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        want = float(jlr(step))
        assert float(tlr(step)) == pytest.approx(want, rel=1e-6, abs=0)
        assert float(tlr(torch.tensor(step, dtype=torch.int32))) == (
            pytest.approx(float(jlr(jnp.asarray(step, jnp.int32))),
                          rel=1e-6, abs=0))


# -------------------------------------------------------------------- data
@pytest.mark.parametrize("arch", ["stablelm-3b", "internvl2-76b",
                                  "seamless-m4t-large-v2"])
def test_batch_at_is_bitwise_the_reference(arch):
    for cfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                      (reduced(get_config(arch)),
                       jax_reduced(jax_get_config(arch)))):
        for seed, index in ((0, 0), (3, 7), (5, 1 << 12)):
            got = SyntheticTokens(cfg, 2, 320, seed=seed).batch_at(index)
            want = JaxSyntheticTokens(jcfg, 2, 320, seed=seed).batch_at(index)
            assert got.keys() == want.keys()
            for k in got:
                assert got[k].dtype == want[k].dtype
                assert np.array_equal(got[k], want[k]), (arch, k)
    it = make_batch_iterator(cfg, 2, 48, seed=3, start_index=6)
    next(it)
    assert np.array_equal(next(it)["tokens"],
                          SyntheticTokens(cfg, 2, 48, 3).batch_at(7)["tokens"])


# ---------------------------------------------------------------- the step
def test_train_step_matches_jax_step():
    """One ``make_train_step`` step (loss, global norm, the updated
    parameters) against the reference's ``make_train_step`` on the same
    batch, reduced stablelm-3b, AdamW.  Its eps is 1e-3 here: Adam's first
    step is lr g / (|g| + eps), and at the default 1e-8 an element with
    |g| near eps turns the gradients' float32 differences (bounded by TOL
    x max |g|, not by |g|) into up to 0.6% of lr; the optimizer alone is
    held at the default eps on equal gradients above."""
    from repro.train.steps import make_train_step as jax_make_train_step
    jcfg, cfg, tree, model = load("stablelm-3b")
    batch = batch_of(cfg.vocab_size, seed=9)
    jstep, jopt = jax_make_train_step(jcfg, joptim.adamw(1e-3, eps=1e-3),
                                      remat=False)
    jp = jax.tree.map(jnp.asarray, tree)
    jp, _, jm = jstep(jp, jopt.init(jp),
                      {k: jnp.asarray(v) for k, v in batch.items()})
    tstep, topt = make_train_step(cfg, toptim.adamw(1e-3, eps=1e-3),
                                  remat=False)
    state = topt.init(dict(model.named_parameters()))
    _, state, tm = tstep(model, state, {k: torch.from_numpy(v).long()
                                        for k, v in batch.items()})
    assert scaled_err(tm["loss"], jm["loss"]) <= TOL
    assert scaled_err(tm["grad_norm"], jm["grad_norm"]) <= TOL
    got = params_to_jax(model.state_dict())
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jp)):
        assert scaled_err(a, b) <= TOL

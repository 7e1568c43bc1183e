"""The port's SSM serving path (xlstm-125m, reduced) against the JAX
reference: weights handed over with ``params_from_jax``, prefill and
teacher-forced decode on the same tokens, the launcher's page pool."""
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
from repro_torch.kernels.ssm_scan import ssm_scan_kernel
from repro_torch.launch.serve import serve
from repro_torch.models import (LanguageModel, decode_step, init_params,
                                prefill)
from repro_torch.models.convert import params_from_jax, params_to_jax

TOL = 1e-4   # port vs reference, float32 on the CPU: scaled by max |ref|
B, S = 2, 32


@pytest.fixture(scope="module")
def models():
    jcfg = jax_reduced(jax_get_config("xlstm-125m"))
    cfg = reduced(get_config("xlstm-125m"))
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    model = init_params(cfg, 1)
    model.load_state_dict(params_from_jax(tree), strict=True)
    return jcfg, cfg, tree, model


def scaled_close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * max(1.0, float(np.max(np.abs(want)))), err


def test_params_from_jax_round_trip(models):
    _, cfg, tree, model = models
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


def test_prefill_and_teacher_forced_decode_match_jax(models):
    jcfg, cfg, tree, model = models
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S + 4))
    jparams = jax.tree.map(jnp.asarray, tree)
    jl, jc = jax_prefill(jparams, jcfg, jnp.asarray(toks[:, :S], jnp.int32),
                         max_len=S + 4, chunk=16)
    tl, tc = prefill(model, cfg, torch.from_numpy(toks[:, :S]))
    scaled_close(tl, jl)
    assert set(tc) == set(jc)
    for k in jc:
        scaled_close(tc[k], jc[k])
    for i in range(4):   # teacher forcing: both fed the same next token
        step = toks[:, S + i:S + i + 1]
        jl, jc = jax_decode_step(jparams, jcfg, jc,
                                 jnp.asarray(step, jnp.int32))
        tl, tc = decode_step(model, cfg, tc, torch.from_numpy(step))
        scaled_close(tl, jl)
    assert int(tc["len"]) == int(jc["len"]) == S + 4


def test_decode_matches_prefill(models):
    """tests/test_models_smoke.py's teacher-forcing consistency, on the
    port alone: decoding token t from a cache of the tokens before it
    gives the prefill's logits at t."""
    _, cfg, _, model = models
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)))
    full, _ = prefill(model, cfg, toks)
    _, cache = prefill(model, cfg, toks[:, :S - 1])
    step, _ = decode_step(model, cfg, cache, toks[:, S - 1:])
    scaled_close(step, full[:, -1])


def test_decode_leaves_its_input_cache_alone(models):
    _, cfg, _, model = models
    toks = torch.arange(2 * 8).reshape(2, 8)
    _, cache = prefill(model, cfg, toks)
    before = {k: v.clone() for k, v in cache.items()}
    decode_step(model, cfg, cache, toks[:, :1])
    assert all(torch.equal(cache[k], v) for k, v in before.items())


def test_serve_on_cpu_gives_the_reference_pool_stats(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "xlstm-125m",
                                      "--reduced"])
    jax_serve.main()
    out = capsys.readouterr().out
    want = {k: int(v) for k, v in re.findall(
        r"(dedup_hits|remote_fetches|slots_used)=(\d+)", out)}
    launches = ssm_scan_kernel.launches
    got = serve("xlstm-125m", reduced=True, device="cpu")
    assert got["pool"] == want and len(want) == 3
    assert got["tokens"].shape == (8, 8)
    assert got["logits"].shape == (8, 8, 256)
    assert np.isfinite(got["logits"]).all()
    # greedy: each token is the argmax of the logits it was chosen from
    assert np.array_equal(got["tokens"], got["logits"].argmax(-1))
    assert ssm_scan_kernel.launches == launches   # the CPU runs no kernel


def test_serve_teacher_forcing_replays_its_own_tokens():
    kw = dict(reduced=True, requests=2, prompt_len=16, gen_len=5,
              shared_prefix_len=8, device="cpu", seed=3)
    free = serve("xlstm-125m", **kw)
    forced = serve("xlstm-125m", teacher_tokens=free["tokens"], **kw)
    assert np.array_equal(forced["tokens"], free["tokens"])
    np.testing.assert_array_equal(forced["logits"], free["logits"])


def test_unported_families_raise():
    with pytest.raises(NotImplementedError, match="section 1 item 4"):
        serve("internvl2-76b", reduced=True, device="cpu")
    with pytest.raises(NotImplementedError, match="audio"):
        LanguageModel(reduced(get_config("seamless-m4t-large-v2")),
                      torch.Generator().manual_seed(0))

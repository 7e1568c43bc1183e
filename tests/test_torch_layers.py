"""The port's configs and building blocks against the JAX reference."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models.model import padded_vocab as jax_padded_vocab
from repro_torch import configs as tconfigs
from repro_torch.models import layers as tlayers
from repro_torch.models import padded_vocab

TOL = 1e-5   # float32 elementwise work and one small product


@pytest.mark.parametrize("arch", jconfigs.ALL_ARCHS)
def test_configs_equal_the_reference(arch):
    want = jconfigs.get_config(arch)
    got = tconfigs.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (dataclasses.asdict(tconfigs.reduced(got))
            == dataclasses.asdict(jconfigs.reduced(want)))
    assert padded_vocab(got) == jax_padded_vocab(want)


def test_padded_vocab_of_xlstm():
    assert padded_vocab(tconfigs.get_config("xlstm-125m")) == 50432


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_jax(kind):
    rng = np.random.default_rng(0)
    x = (3 * rng.standard_normal((2, 5, 24)) + 1).astype(np.float32)
    g = rng.standard_normal(24).astype(np.float32)
    want = jlayers.apply_norm(kind, jnp.asarray(x), jnp.asarray(g))
    got = tlayers.apply_norm(kind, torch.from_numpy(x), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("activation", ["gelu", "swiglu"])
def test_mlp_matches_jax(activation):
    """jax.nn.gelu is the tanh approximation; the port must use it too."""
    p = jlayers.mlp_init(jax.random.PRNGKey(1), 16, 40, activation,
                         jnp.float32)
    x = np.random.default_rng(1).standard_normal((3, 16)).astype(
        np.float32) * 2
    want = jlayers.mlp_apply(p, jnp.asarray(x), activation)
    got = tlayers.mlp_apply({k: torch.from_numpy(np.array(v))
                             for k, v in p.items()},
                            torch.from_numpy(x), activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_dense_init_is_a_truncated_normal_from_its_seed():
    a = tlayers.dense_init(torch.Generator().manual_seed(0), (256, 512))
    b = tlayers.dense_init(torch.Generator().manual_seed(0), (256, 512))
    assert torch.equal(a, b)
    std = 1 / np.sqrt(256)
    assert float(a.abs().max()) <= 2 * std
    # a standard normal cut at +-2 has standard deviation 0.8796
    assert abs(float(a.std()) / std - 0.8796) < 0.01
    ref = jlayers.dense_init(jax.random.PRNGKey(0), (256, 512), jnp.float32)
    assert abs(float(a.std()) - float(jnp.std(ref))) < 0.01 * std

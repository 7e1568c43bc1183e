"""The port's int8 error-feedback compression
(``repro_torch.distributed.compression``) against the JAX reference on
the CPU: the four cases of ``tests/test_compression.py`` on the port,
then ``quantize_int8``, ``ef_compress`` and ``ef_compress_tree`` bitwise
against the reference on seeded numpy float32 inputs (zeros, a single
nonzero, magnitudes from 1e-6 to 1e6), and ``compressed_psum`` through
a one-rank gloo group bitwise against the reference's ``shard_map``
over a one-device mesh.  Everything is exact: no tolerance."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings, strategies as st
from jax.sharding import PartitionSpec

from repro.distributed import compression as jcomp
from repro_torch.distributed.compression import (compressed_psum,
                                                 dequantize_int8,
                                                 ef_compress,
                                                 ef_compress_tree,
                                                 init_residuals,
                                                 quantize_int8)
from repro_torch.launch.mesh import make_host_mesh


def normal(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32))


# ------------------------------------- tests/test_compression.py's cases
def test_quantize_bounds_error():
    x = normal(0, (256,))
    q, s = quantize_int8(x)
    err = (dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-6


def test_error_feedback_mean_converges():
    """The sum of sent values approaches the sum of true gradients
    (unbiased in the long run): the residual never grows."""
    residual = torch.zeros(128)
    total_true = torch.zeros(128)
    total_sent = torch.zeros(128)
    for i in range(30):
        g = normal(100 + i, (128,), 1 + i % 3)
        q, s, residual = ef_compress(g, residual)
        total_true += g
        total_sent += dequantize_int8(q, s)
    gap = (total_true - total_sent).abs()
    assert float(gap.max()) < 0.2  # tiny vs accumulated magnitude ~sqrt(30)*2
    # what was not sent is exactly what the residual carries
    torch.testing.assert_close(total_true - total_sent, residual,
                               rtol=0, atol=1e-5)


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 10_000))
def test_property_ef_residual_bounded(seed):
    residual = torch.zeros(64)
    for i in range(5):
        g = normal((seed, i), (64,), 10.0)
        _, s, residual = ef_compress(g, residual)
        # residual can never exceed half a quantization step
        assert float(residual.abs().max()) <= float(s) * 0.5 + 1e-5


def test_tree_api():
    params = {"a": torch.ones((8, 8)), "b": torch.ones((4,))}
    res = init_residuals(params)
    assert all(r.dtype == torch.float32 and not r.any() for r in res.values())
    grads = {k: p * 0.5 for k, p in params.items()}
    sent, new_res = ef_compress_tree(grads, res)
    assert list(sent) == list(params) and list(new_res) == list(params)
    for k, g in grads.items():
        assert sent[k].shape == g.shape
        torch.testing.assert_close(sent[k], g, rtol=0, atol=0.01)


# ------------------------------------- bitwise against the reference
def inputs(case):
    """Seeded float32 inputs of (12, 40): standard normals scaled by
    10**k for k in [-6, 6], zeros, one nonzero, and rows of magnitudes
    spread over 1e-6 to 1e6 in one tensor."""
    if case == "zeros":
        return np.zeros((12, 40), np.float32)
    if case == "one nonzero":
        x = np.zeros((12, 40), np.float32)
        x[5, 17] = -3.25
        return x
    if case == "spread":
        rng = np.random.default_rng(7)
        return (rng.standard_normal((12, 40))
                * 10.0 ** rng.uniform(-6, 6, (12, 1))).astype(np.float32)
    k = int(case)
    rng = np.random.default_rng(1000 + k)
    return (rng.standard_normal((12, 40)) * 10.0 ** k).astype(np.float32)


CASES = ["zeros", "one nonzero", "spread"] + [str(k) for k in range(-6, 7)]


def bitwise(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert str(got.dtype) == f"torch.{want.dtype}", (got.dtype, want.dtype)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().reshape(-1).view(np.uint8),
                                  want.reshape(-1).view(np.uint8))


@pytest.mark.parametrize("case", CASES)
def test_quantize_int8_matches_jax_bitwise(case):
    x = inputs(case)
    q, s = quantize_int8(torch.from_numpy(x))
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    bitwise(q, jq)
    bitwise(s, js)
    bitwise(dequantize_int8(q, s), jcomp.dequantize_int8(jq, js))


@pytest.mark.parametrize("case", CASES)
def test_ef_compress_matches_jax_bitwise(case):
    g = inputs(case)
    r = (np.random.default_rng(5).standard_normal(g.shape)
         * max(float(np.abs(g).max()), 1e-3) * 1e-3).astype(np.float32)
    for res in (np.zeros_like(g), r):
        got = ef_compress(torch.from_numpy(g), torch.from_numpy(res))
        want = jcomp.ef_compress(jnp.asarray(g), jnp.asarray(res))
        for a, b in zip(got, want):
            bitwise(a, b)


def test_ef_compress_tree_matches_jax_bitwise():
    grads = {case: inputs(case) for case in CASES}
    grads["bias"] = np.linspace(-1, 1, 7, dtype=np.float32)
    res = {k: np.zeros_like(v) for k, v in grads.items()}
    t_res = init_residuals({k: torch.from_numpy(v) for k, v in res.items()})
    j_res = jcomp.init_residuals({k: jnp.asarray(v) for k, v in res.items()})
    # two steps: the second replays the first's residuals
    for _ in range(2):
        sent, t_res = ef_compress_tree(
            {k: torch.from_numpy(v) for k, v in grads.items()}, t_res)
        j_sent, j_res = jcomp.ef_compress_tree(
            {k: jnp.asarray(v) for k, v in grads.items()}, j_res)
        for k in grads:
            bitwise(sent[k], j_sent[k])
            bitwise(t_res[k], j_res[k])


@pytest.fixture(scope="module")
def host_mesh():
    # the mesh's one-rank gloo group ends with the module, so no later
    # test in this process finds a group of another backend running
    yield make_host_mesh(device="cpu")
    dist.destroy_process_group()


@pytest.mark.parametrize("case", ["spread", "one nonzero", "3"])
def test_compressed_psum_matches_jax_bitwise(host_mesh, case):
    x = inputs(case)
    got = compressed_psum(torch.from_numpy(x), host_mesh.get_group("data"))
    mesh = jax.make_mesh((1,), ("data",))
    fn = jax.shard_map(functools.partial(jcomp.compressed_psum,
                                         axis_name="data"),
                       mesh=mesh, in_specs=PartitionSpec(),
                       out_specs=PartitionSpec(), check_vma=False)
    # op by op, as the reference's text divides; under jax.jit XLA turns
    # "/ 127.0" into a product with the reciprocal, and "one nonzero"
    # (-3.25) comes back as -3.2499998 (ROADMAP.md section 3)
    want = fn(jnp.asarray(x))
    bitwise(got, want)
    # one rank: the sum is the rank's own dequantized codes
    assert torch.equal(got, dequantize_int8(*quantize_int8(
        torch.from_numpy(x))))

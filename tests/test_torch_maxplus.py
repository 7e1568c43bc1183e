"""maxplus_scan in the PyTorch port: the reference's kernel cases on the
port's backends (CPU tensors run each kernel's plain version), a
differential against the JAX package on the same arrays.  The CUDA
kernels themselves are tested in ``test_torch_kernels_cuda.py``."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.maxplus_scan import maxplus_depart as jax_depart
from repro_torch.kernels.maxplus_scan import (maxplus_chunked,
                                              maxplus_chunked_ref,
                                              maxplus_depart,
                                              maxplus_depart_ref)


def numpy_oracle(arrive, svc):
    """The expression the fast engine historically inlined."""
    s = np.cumsum(svc, axis=-1)
    return s + np.maximum.accumulate(arrive - (s - svc), axis=-1)


def sequential_oracle(arrive, svc, reset=None, init=None):
    out = np.empty_like(arrive)
    flat_a = arrive.reshape(-1, arrive.shape[-1])
    flat_s = svc.reshape(-1, arrive.shape[-1])
    flat_r = (None if reset is None
              else reset.reshape(-1, arrive.shape[-1]))
    for r in range(flat_a.shape[0]):
        d = -np.inf if init is None else float(np.asarray(init).reshape(-1)[
            r % np.asarray(init).size])
        for i in range(arrive.shape[-1]):
            if flat_r is not None and flat_r[r, i]:
                d = -np.inf
            d = max(flat_a[r, i], d) + flat_s[r, i]
            out.reshape(-1, arrive.shape[-1])[r, i] = d
    return out


def make(shape, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    arrive = np.sort(rng.random(shape), axis=-1).astype(dtype) * 10
    svc = (rng.random(shape) * 0.3).astype(dtype)
    return arrive, svc


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def run(a, s, **kw):
    return maxplus_depart(t(a), t(s), **kw).numpy()


# ------------------------------------------- the reference's kernel cases
@pytest.mark.parametrize("L", [1, 7, 128, 1000])
def test_numpy_backend_is_bit_exact_vs_inline_oracle(L):
    a, s = make((3, L))
    got = maxplus_depart(a, s, backend="numpy")
    assert np.array_equal(got, numpy_oracle(a, s))


@pytest.mark.parametrize("backend", ["assoc", "ref", "cuda"])
@pytest.mark.parametrize("L", [8, 250, 1000])
def test_torch_backends_match_numpy_oracle_f64(backend, L):
    a, s = make((4, L), seed=L)
    got = run(a, s, backend=backend)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, numpy_oracle(a, s), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("backend", ["assoc", "cuda"])
def test_float32_tolerance(backend):
    a, s = make((2, 600), seed=5, dtype=np.float32)
    got = run(a, s, backend=backend)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, numpy_oracle(a, s), rtol=1e-5,
                               atol=1e-5)


def test_auto_backend_dispatch():
    a, s = make((2, 32))
    assert isinstance(maxplus_depart(a, s), np.ndarray)
    out = maxplus_depart(t(a), t(s))
    assert isinstance(out, torch.Tensor)
    assert np.array_equal(out.numpy(), maxplus_depart(t(a), t(s),
                                                      backend="assoc"))


@pytest.mark.parametrize("backend", ["numpy", "assoc", "ref"])
def test_segment_resets(backend):
    a, s = make((3, 40), seed=9)
    reset = np.zeros((3, 40), bool)
    reset[:, 13] = True
    reset[1, 0] = True
    reset[2, 39] = True
    want = sequential_oracle(a, s, reset=reset)
    if backend == "numpy":
        got = maxplus_depart(a, s, reset=reset, backend="numpy")
    else:
        got = run(a, s, reset=t(reset), backend=backend)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("backend", ["numpy", "assoc", "ref", "cuda"])
def test_init_busy_leader(backend):
    a, s = make((4, 300), seed=3)
    init = np.array([0.0, 5.0, 20.0, 2.5])
    want = sequential_oracle(a, s, init=init)
    if backend == "numpy":
        got = maxplus_depart(a, s, init=init, backend="numpy")
    else:
        got = run(a, s, init=t(init), backend=backend)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_cuda_backend_rows_are_independent():
    """The carry must reset per row: permuting rows permutes
    departures."""
    a, s = make((5, 300), seed=11)
    out = run(a, s, backend="cuda")
    perm = np.array([3, 1, 4, 0, 2])
    out_p = run(a[perm], s[perm], backend="cuda")
    np.testing.assert_allclose(out_p, out[perm], rtol=1e-12)


def test_cuda_backend_pad_to_chunk():
    """A length that is not a multiple of the tile ends in a shorter
    chunk, with the same result as the reference's zero padding."""
    a, s = make((2, 300), seed=13)
    got = run(a, s, backend="cuda")
    np.testing.assert_allclose(got, numpy_oracle(a, s), rtol=1e-12)


def test_chunked_direct_multiple_of_chunk():
    a, s = make((3, 512), seed=17, dtype=np.float32)
    got = maxplus_chunked(t(a), t(s)).numpy()
    np.testing.assert_allclose(got, numpy_oracle(a, s), rtol=1e-5,
                               atol=1e-5)


def run_in_row_blocks(a, s, block_rows):
    """The cuda backend over the rows taken ``block_rows`` at a time."""
    return np.concatenate([
        run(a[i:i + block_rows], s[i:i + block_rows], backend="cuda")
        for i in range(0, len(a), block_rows)])


@pytest.mark.parametrize("block_rows", [2, 4, 8])
@pytest.mark.parametrize("R,L", [(1, 64), (5, 96), (16, 300)])
def test_cuda_backend_batched_rows_matches_oracle(block_rows, R, L):
    """Rows taken in blocks; results must not depend on the block size,
    including when R is not a multiple of it.  (On the card the rows per
    CTA are the kernel's blocks: ``test_torch_kernels_cuda.py``.)"""
    a, s = make((R, L), seed=R * 100 + L)
    got = run_in_row_blocks(a, s, block_rows)
    np.testing.assert_allclose(got, numpy_oracle(a, s), rtol=1e-12,
                               atol=1e-12)


def test_cuda_backend_block_rows_bitwise_vs_block_rows_one():
    """Row blocking is pure batching: each row's scan is independent, so
    the block size must be bit-invisible, not just within tolerance."""
    a, s = make((7, 300), seed=41)
    one = run_in_row_blocks(a, s, 1)
    many = run(a, s, backend="cuda")
    assert np.array_equal(one, many)


@pytest.mark.parametrize("backend", ["numpy", "ref"])
def test_monotone_departures_and_fifo_invariant(backend):
    """Departures are nondecreasing in op order and each op departs no
    earlier than its own arrival + service."""
    a, s = make((1, 200), seed=23)
    d = (maxplus_depart(a, s) if backend == "numpy"
         else run(a, s, backend=backend))
    assert np.all(np.diff(d[0]) >= 0)
    assert np.all(d >= a + s - 1e-12)


def test_ref_rejects_nothing_on_1d():
    a, s = make((16,), seed=29)
    got = maxplus_depart_ref(a, s).numpy()
    np.testing.assert_allclose(got, numpy_oracle(a, s), rtol=1e-12)


def test_cuda_backend_rejects_reset():
    a, s = make((2, 16))
    with pytest.raises(NotImplementedError):
        maxplus_depart(t(a), t(s), reset=t(np.zeros((2, 16), bool)),
                       backend="cuda")
    with pytest.raises(ValueError):
        maxplus_depart(t(a), t(s), backend="pallas")


# ------------------------------------------- differential against JAX
def jax_run(a, s, **kw):
    with jax.enable_x64(a.dtype == np.float64):
        return np.asarray(jax_depart(
            jnp.asarray(a), jnp.asarray(s),
            **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}))


@pytest.mark.parametrize("R,L", [(1, 1), (4, 250), (9, 1000)])
def test_ref_bitwise_vs_jax_ref(R, L):
    a, s = make((R, L), seed=R + L)
    init = np.linspace(0.0, 8.0, R)
    assert np.array_equal(run(a, s, backend="ref"),
                          jax_run(a, s, backend="ref"))
    assert np.array_equal(run(a, s, backend="ref", init=t(init)),
                          jax_run(a, s, backend="ref", init=init))


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12),
                                        (np.float32, 1e-5)])
@pytest.mark.parametrize("R,L,chunk", [(3, 64, 16), (8, 1000, 256)])
def test_chunked_plain_vs_jax_pallas_interpret(dtype, rtol, R, L, chunk):
    """Same chunked closed form, so the two agree to rounding (cumsum
    association differs between the frameworks)."""
    a, s = make((R, L), seed=L, dtype=dtype)
    init = np.linspace(0.0, 8.0, R).astype(dtype)
    for kw in ({}, {"init": init}):
        want = jax_run(a, s, backend="pallas", chunk=chunk, block_rows=8,
                       interpret=True, **kw)
        got = maxplus_chunked_ref(t(a), t(s), chunk=chunk,
                                  **{k: t(v) for k, v in kw.items()}).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol)


def test_assoc_reset_vs_jax_assoc_reset():
    a, s = make((3, 70), seed=31)
    reset = np.zeros((3, 70), bool)
    reset[:, [5, 33]] = True
    reset[2, 0] = True
    init = np.array([1.0, 4.0, 9.0])
    for kw in ({}, {"init": init}):
        want = jax_run(a, s, reset=reset, backend="assoc", **kw)
        got = run(a, s, reset=t(reset), backend="assoc",
                  **{k: t(v) for k, v in kw.items()})
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)

"""The port's CUDA kernels and its sweep on the GPU, against their plain
PyTorch versions on the same inputs.  Every test needs a GPU and skips
without one; run them on a GPU host with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

This file imports neither jax nor the reference package, so it runs on a
host that has only torch and numpy."""
from dataclasses import asdict

import numpy as np
import pytest
import torch

from repro_torch.kernels.maxplus_scan import kernel as mp_kernel
from repro_torch.kernels.maxplus_scan import (maxplus_chunked,
                                              maxplus_chunked_ref,
                                              maxplus_depart,
                                              maxplus_depart_ref,
                                              maxplus_seq)
from repro_torch.sim.sweep import closed_grid, run_sweep, sweep_grid

pytestmark = pytest.mark.cuda


def make(R, L, seed, dtype):
    rng = np.random.default_rng(seed)
    a = np.sort(rng.random((R, L)), axis=-1) * 10
    s = rng.random((R, L)) * 0.3
    return (torch.from_numpy(a).to(dtype), torch.from_numpy(s).to(dtype))


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("R,L", [(1, 1), (5, 37), (33, 1000)])
def test_chunked_kernel_vs_plain(cuda_device, monkeypatch, dtype, rtol, R,
                                 L):
    a, s = make(R, L, R * L, dtype)
    init = torch.linspace(0.0, 8.0, R, dtype=dtype)
    for x0 in (None, init):
        want = maxplus_chunked_ref(a, s, x0)
        got = maxplus_chunked(a.to(cuda_device), s.to(cuda_device),
                              None if x0 is None else x0.to(cuda_device))
        torch.testing.assert_close(got.cpu(), want, rtol=rtol, atol=rtol)
    # the rows per CTA must be bit-invisible
    a, s = a.to(cuda_device), s.to(cuda_device)
    many = maxplus_chunked(a, s)
    monkeypatch.setattr(mp_kernel, "WARPS_PER_CTA", 1)
    assert torch.equal(maxplus_chunked(a, s), many)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("R,L", [(1, 1), (5, 37), (33, 1000)])
def test_seq_kernel_bitwise_vs_plain(cuda_device, dtype, R, L):
    a, s = make(R, L, R + 7 * L, dtype)
    reset = torch.zeros((R, L), dtype=torch.bool)
    reset[:, L // 2] = True
    init = torch.linspace(0.0, 8.0, R, dtype=dtype)
    for kw in ({}, {"reset": reset}, {"init": init}):
        want = maxplus_depart_ref(a, s, **kw)
        got = maxplus_seq(a.to(cuda_device), s.to(cuda_device),
                          **{k: v.to(cuda_device) for k, v in kw.items()})
        assert torch.equal(got.cpu(), want)


def test_wrappers_count_and_reject(cuda_device):
    a, s = make(4, 64, 0, torch.float64)
    a, s = a.to(cuda_device), s.to(cuda_device)
    before = (maxplus_chunked.launches, maxplus_seq.launches)
    maxplus_depart(a, s, backend="cuda")
    maxplus_depart(a, s, backend="ref")
    assert (maxplus_chunked.launches, maxplus_seq.launches) == (
        before[0] + 1, before[1] + 1)
    with pytest.raises(ValueError):
        maxplus_seq(a[:, ::2], s[:, ::2])          # not contiguous
    with pytest.raises(TypeError):
        maxplus_chunked(a.half(), s.half())
    with pytest.raises(ValueError):
        maxplus_chunked(a, s.cpu())


def _assert_columns_match(got, want, rtol):
    for name, w in want.columns.items():
        g = got.columns[name]
        assert np.array_equal(np.isnan(g), np.isnan(w)), name
        ok = ~np.isnan(w)
        assert np.all(np.abs(g[ok] - w[ok])
                      <= rtol * np.maximum(1.0, np.abs(w[ok]))), name


def test_sweep_on_gpu_matches_cpu(cuda_device):
    grid = sweep_grid()[::16]
    _assert_columns_match(run_sweep(grid, device=cuda_device),
                          run_sweep(grid, device="cpu"), 1e-9)
    pts = closed_grid(threads=4, ops=40)[:4]
    got = run_sweep(pts, loop="closed", device=cuda_device)
    want = run_sweep(pts, loop="closed", device="cpu")
    # the sequential kernel is bitwise, so the fixed points are identical
    _assert_columns_match(got, want, 0.0)
    assert got.info["rounds"] == want.info["rounds"]
    assert [asdict(p) for p in got.points] == [asdict(p) for p in pts]

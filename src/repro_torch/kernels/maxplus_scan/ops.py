"""Dispatch wrapper for the max-plus departure scan.

Four interchangeable evaluations of ``d_i = max(a_i, d_{i-1}) + s_i``:

* ``numpy`` — the closed form ``S + cummax(a - exclusive_cumsum(s))``
  (the expression the fast simulator engine historically inlined as
  ``np.maximum.accumulate``); exact float64, zero dispatch overhead, the
  right choice for host-side per-group scans.
* ``ref`` — the exact sequential recurrence: the ``maxplus_seq`` CUDA
  kernel on a CUDA tensor, its plain loop (``ref.py``) on a CPU tensor.
* ``assoc`` — torch ``cumsum`` + ``cummax`` closed form; with ``reset``,
  a log-step doubling scan over max-plus affine maps ``x -> max(x + m,
  c)``, which compose associatively as ``(m1,c1)∘(m2,c2) = (m1+m2,
  max(c1+m2, c2))``; a *segment reset* is just ``m = -inf`` (the map
  forgets its input).
* ``cuda`` — the ``maxplus_chunked`` warp-scan kernel on a CUDA tensor,
  its plain chunked version (chunked at the kernel's tile) on a CPU
  tensor.  Rows are its segments, so it rejects ``reset``.

``backend="auto"`` picks ``numpy`` for numpy inputs and ``assoc`` for
tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from .kernel import maxplus_chunked, maxplus_seq


def _assoc(arrive, svc, reset, init):
    a = torch.as_tensor(arrive)
    s = torch.as_tensor(svc, dtype=a.dtype, device=a.device)
    x0 = None if init is None else torch.as_tensor(init, dtype=a.dtype,
                                                   device=a.device)
    if x0 is not None and x0.dim():
        x0 = x0.unsqueeze(-1)
    if reset is None:
        # closed form: two single-array scans (cumsum + cummax) instead of
        # one over (m, c) pairs — half the scan work
        S = torch.cumsum(s, dim=-1)
        z = torch.cummax(a - (S - s), dim=-1).values
        if x0 is not None:
            z = torch.maximum(z, x0)
        return S + z
    rs = torch.as_tensor(reset, dtype=torch.bool, device=a.device)
    M = torch.where(rs, torch.tensor(-torch.inf, dtype=a.dtype,
                                      device=a.device), s)
    M = torch.broadcast_to(M, a.shape).clone()
    C = a + s
    L, k = a.shape[-1], 1
    while k < L:
        # Hillis-Steele step: fold in the map k positions earlier
        m_prev, c_prev = M[..., :-k], C[..., :-k]
        m_cur, c_cur = M[..., k:], C[..., k:]
        M = torch.cat([M[..., :k], m_prev + m_cur], dim=-1)
        C = torch.cat([C[..., :k], torch.maximum(c_prev + m_cur, c_cur)],
                      dim=-1)
        k *= 2
    if x0 is None:
        return C
    return torch.maximum(C, x0 + M)


def _numpy(arrive, svc, reset, init):
    a = np.asarray(arrive)
    s = np.asarray(svc, a.dtype)
    if reset is not None and np.asarray(reset).any():
        rs = np.broadcast_to(np.asarray(reset, bool), a.shape)
        out = np.empty_like(a)
        flat_a = a.reshape(-1, a.shape[-1])
        flat_s = s.reshape(-1, a.shape[-1])
        flat_r = rs.reshape(-1, a.shape[-1])
        flat_o = out.reshape(-1, a.shape[-1])
        for row in range(flat_a.shape[0]):
            starts = np.flatnonzero(flat_r[row]).tolist()
            bounds = [0] + [b for b in starts if b > 0] + [a.shape[-1]]
            x0 = init
            for lo, hi in zip(bounds[:-1], bounds[1:]):
                flat_o[row, lo:hi] = _numpy_seg(
                    flat_a[row, lo:hi], flat_s[row, lo:hi],
                    None if flat_r[row, lo] else x0)
                x0 = None  # later segments start from an idle leader
        return out
    return _numpy_seg(a, s, init)


def _numpy_seg(a, s, init):
    S = np.cumsum(s, axis=-1)
    cm = np.maximum.accumulate(a - (S - s), axis=-1)
    if init is not None:
        cm = np.maximum(cm, np.asarray(init)[..., None]
                        if np.ndim(init) else init)
    return S + cm


def _rows(arrive, svc, init):
    """(..., L) tensors as contiguous (R, L) rows plus an (R,) init."""
    a = torch.as_tensor(arrive)
    s = torch.as_tensor(svc, dtype=a.dtype, device=a.device)
    shape = a.shape
    a2 = a.reshape(-1, shape[-1]).contiguous()
    s2 = torch.broadcast_to(s, shape).reshape(-1, shape[-1]).contiguous()
    x0 = None
    if init is not None:
        x0 = torch.broadcast_to(
            torch.as_tensor(init, dtype=a.dtype, device=a.device),
            shape[:-1]).reshape(-1).contiguous()
    return a2, s2, x0, shape


def maxplus_depart(arrive, svc, reset=None, *, init=None,
                   backend: str = "auto"):
    """Departure times for the leader-stage recurrence.  (..., L) in,
    (..., L) out; see the module docstring for the backends.

    ``init`` seeds each row's carry (idle leader = -inf); every backend
    supports it.
    """
    if backend == "auto":
        backend = "numpy" if not isinstance(arrive, torch.Tensor) \
            else "assoc"
    if backend == "numpy":
        return _numpy(arrive, svc, reset, init)
    if backend == "assoc":
        return _assoc(arrive, svc, reset, init)
    if backend == "ref":
        a2, s2, x0, shape = _rows(arrive, svc, init)
        rs = None
        if reset is not None:
            rs = torch.broadcast_to(
                torch.as_tensor(reset, dtype=torch.bool, device=a2.device),
                shape).reshape(a2.shape).contiguous()
        return maxplus_seq(a2, s2, reset=rs, init=x0).reshape(shape)
    if backend != "cuda":
        raise ValueError(f"unknown backend {backend!r}")
    if reset is not None:
        raise NotImplementedError(
            "the cuda backend segments by row; pre-split sequences into "
            "rows instead of passing reset")
    # the kernel and its plain version take ragged rows as they are: the
    # reference's zero padding to whole chunks and row blocks is inert
    # (arrive=0, svc=0 just carries the last departure forward), so it
    # would change no value and is not done
    a2, s2, x0, shape = _rows(arrive, svc, init)
    return maxplus_chunked(a2, s2, x0).reshape(shape)

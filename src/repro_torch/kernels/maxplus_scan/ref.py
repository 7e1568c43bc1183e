"""Plain PyTorch versions of the max-plus departure recurrence.

The EdgeKV simulator's only true serialization point is each group
leader's capacity-1 commit stage: op ``i`` starts service when both it has
arrived *and* the previous op has departed,

    depart_i = max(arrive_i, depart_{i-1}) + svc_i .

Two plain versions live here, each the CPU twin of one CUDA kernel in
``kernel.py``:

* :func:`maxplus_depart_ref` — the semantic ground truth: a loop that
  steps the recurrence one op at a time, in the working dtype, in the
  engine's exact float order (twin of the sequential kernel).
* :func:`maxplus_chunked_ref` — the chunked closed form
  ``d = S + max(cummax(a - (S - s)), carry)`` per chunk, with ``S`` the
  in-chunk cumsum of ``s`` and the carry handed chunk to chunk (twin of
  the warp-scan kernel).  It reassociates the adds, so it agrees with the
  sequential form to rounding, not bitwise.
"""
from __future__ import annotations

from typing import Optional

import torch

# The warp-scan kernel's tile: 32 lanes x V consecutive elements per lane
# (V = 4 in float64, 8 in float32).  The plain chunked version cuts its
# chunks at the same places, so both hand the carry over at the same
# elements.
TILE = {torch.float64: 128, torch.float32: 256}


def _as_pair(arrive, svc):
    a = torch.as_tensor(arrive)
    return a, torch.as_tensor(svc, dtype=a.dtype, device=a.device)


def _start(a: torch.Tensor, init) -> torch.Tensor:
    """Per-row carry before the first op: ``init`` broadcast over the
    batch shape, or -inf (an idle leader)."""
    if init is None:
        return torch.full(a.shape[:-1], -torch.inf, dtype=a.dtype,
                          device=a.device)
    x0 = torch.as_tensor(init, dtype=a.dtype, device=a.device)
    return torch.broadcast_to(x0, a.shape[:-1]).clone()


def maxplus_depart_ref(arrive, svc, reset=None, init=None) -> torch.Tensor:
    """Sequential recurrence over the last axis.  ``arrive``/``svc``:
    (..., L).

    ``reset`` (optional bool, same shape) restarts the recurrence at
    flagged positions — op ``i`` sees an idle leader.  ``init`` (optional
    scalar or (...,) tensor) is the leader's free time before the first
    op; ``None`` means an idle leader (-inf).
    """
    a, s = _as_pair(arrive, svc)
    d = _start(a, init)
    rs = None if reset is None else torch.broadcast_to(
        torch.as_tensor(reset, dtype=torch.bool, device=a.device), a.shape)
    neg = torch.tensor(-torch.inf, dtype=a.dtype, device=a.device)
    out = torch.empty_like(a)
    for i in range(a.shape[-1]):
        prev = d if rs is None else torch.where(rs[..., i], neg, d)
        d = torch.maximum(a[..., i], prev) + s[..., i]
        out[..., i] = d
    return out


def maxplus_chunked_ref(arrive, svc, init=None,
                        chunk: Optional[int] = None) -> torch.Tensor:
    """The chunked closed form, row by row over the last axis, in chunks
    of ``chunk`` elements (default: the kernel's tile for the dtype).  A
    ragged last chunk is simply shorter: the scan is causal, so what
    would follow it as zero padding cannot change it."""
    a, s = _as_pair(arrive, svc)
    if chunk is None:
        chunk = TILE[a.dtype]
    carry = _start(a, init).unsqueeze(-1)
    out = torch.empty_like(a)
    for lo in range(0, a.shape[-1], chunk):
        ac, sc = a[..., lo:lo + chunk], s[..., lo:lo + chunk]
        S = torch.cumsum(sc, dim=-1)
        zc = torch.cummax(ac - (S - sc), dim=-1).values
        d = S + torch.maximum(zc, carry)
        out[..., lo:lo + chunk] = d
        carry = d[..., -1:]
    return out

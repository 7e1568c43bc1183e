"""Plain PyTorch versions of the SSD scan, in the kernel's head-folded
layout: x (BH, S, P), loga and dt (BH, S, 1), Bm and Cm (BH, S, N), the
state h (BH, N, P).  Sums and state are float32, or float64 for float64
inputs (the oracle the kernel's accuracy is measured against).

* :func:`ssd_ref` — one recurrence step per token, the oracle
  (``repro/models/ssm.py::ssd_ref`` with one head per row).
* :func:`ssd_chunked_ref` — the chunkwise form the kernel computes
  (``repro/models/ssm.py::ssd_chunked``): the masked decay matrix within
  a chunk, the state passed across chunks.  CPU tensors run it in place
  of the kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _acc(x: torch.Tensor) -> torch.dtype:
    """The type of the sums and the state: float32 at least."""
    return torch.promote_types(x.dtype, torch.float32)


def _state(h0: Optional[torch.Tensor], BH: int, N: int, P: int,
           like: torch.Tensor) -> torch.Tensor:
    if h0 is None:
        return torch.zeros((BH, N, P), dtype=_acc(like), device=like.device)
    return h0.to(_acc(like))


def ssd_ref(x, loga, dt, Bm, Cm, h0=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential scan: ``h = a_t h + B_t (x_t dt_t)``, ``y_t = C_t h``."""
    BH, S, P = x.shape
    N = Bm.shape[-1]
    h = _state(h0, BH, N, P, x)
    acc = h.dtype
    ys = []
    for t in range(S):
        a = torch.exp(loga[:, t]).to(acc)                   # (BH, 1)
        upd = torch.einsum("bd,bp->bdp", Bm[:, t].to(acc),
                           (x[:, t] * dt[:, t]).to(acc))
        h = h * a[..., None] + upd
        ys.append(torch.einsum("bd,bdp->bp", Cm[:, t].to(acc), h))
    return torch.stack(ys, dim=1).to(x.dtype), h


def ssd_chunked_ref(x, loga, dt, Bm, Cm, *, chunk: int = 128,
                    h0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked scan with chunks of ``min(chunk, S)`` tokens, which must
    divide S.  Returns (y (BH, S, P), h_final (BH, N, P))."""
    BH, S, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if Q < 1 or S % Q:
        raise ValueError(f"sequence {S} not divisible by chunk {Q}")
    NC = S // Q
    acc = _acc(x)
    xw = (x * dt).to(acc).reshape(BH, NC, Q, P)
    Bc = Bm.to(acc).reshape(BH, NC, Q, N)
    Cc = Cm.to(acc).reshape(BH, NC, Q, N)
    cum = torch.cumsum(loga.to(acc).reshape(BH, NC, Q), dim=2)

    # within a chunk: masked decay matrix.  Select, never multiply by the
    # mask: above the diagonal exp may be inf, and inf * 0 is nan
    dd = cum[..., :, None] - cum[..., None, :]              # (BH,NC,t,s)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    decay = torch.where(tri, torch.exp(dd), dd.new_zeros(()))
    CB = torch.einsum("bnqd,bnsd->bnqs", Cc, Bc)
    y_intra = torch.einsum("bnqs,bnsp->bnqp", CB * decay, xw)

    # chunk summaries, then the state passed from chunk to chunk
    tail = torch.exp(cum[..., -1:] - cum)                   # (BH,NC,Q)
    states = torch.einsum("bnsd,bnsp->bndp", Bc, xw * tail[..., None])
    chunk_decay = torch.exp(cum[..., -1])                   # (BH,NC)
    h = _state(h0, BH, N, P, x)
    h_prevs = []
    for c in range(NC):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, None, None] + states[:, c]
    y_inter = torch.einsum("bnqd,bndp->bnqp", Cc,
                           torch.stack(h_prevs, dim=1)) * torch.exp(cum)[
                               ..., None]
    return (y_intra + y_inter).reshape(BH, S, P).to(x.dtype), h

"""Entry point of the SSD scan: the head-folded chunked scan on the
device its tensors lie on."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .kernel import ssm_scan_kernel
from .ref import ssd_chunked_ref


def ssm_scan(x: torch.Tensor, loga: torch.Tensor, dt: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Head-folded chunked SSD: x (BH, S, P), loga/dt (BH, S, 1), Bm/Cm
    (BH, S, N), optional h0 (BH, N, P).  Returns (y (BH, S, P), h_final
    (BH, N, P)) with chunks of ``min(chunk, S)`` tokens, which must
    divide S.

    CPU tensors run the plain chunked version; any other tensors go to
    the ``ssd_chunked`` CUDA kernel, which raises off a CUDA device.
    There is no other fallback.
    """
    if x.device.type == "cpu":
        return ssd_chunked_ref(x, loga, dt, Bm, Cm, chunk=chunk, h0=h0)
    args = [t.contiguous() for t in (x, loga, dt, Bm, Cm)]
    return ssm_scan_kernel(*args, chunk=chunk,
                           h0=None if h0 is None else h0.contiguous())

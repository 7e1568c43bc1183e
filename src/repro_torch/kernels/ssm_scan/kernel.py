"""The CUDA kernel of the chunked SSD scan, its build and its wrapper.

``csrc/ssd_chunked.cu`` is the hand-written Hopper (``sm_90a``) port of
the Pallas kernel ``repro/kernels/ssm_scan/kernel.py::ssm_scan_kernel``:
one CTA per (head-folded row, tile of state columns) carries its slice
of the float32 state through the row's chunks in shared memory (the
source's header gives the design and its bound).  Unlike the TPU kernel
it starts from an optional ``h0`` and returns the final state, which
prefill hands to the decode cache.  It is built and loaded by
:mod:`..cuda_build`.

:func:`ssm_scan_kernel` takes CUDA tensors only (``ops.ssm_scan``
sends CPU tensors to the plain chunked version): it checks device,
dtype, shapes and contiguity, allocates the outputs, launches on the
current stream, checks the launch and adds one to its ``launches``
count.  Nothing falls back: a failed build or launch raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from .. import cuda_build
from ..cuda_build import I64, INT, P

CSRC = Path(__file__).resolve().parent / "csrc"
cuda_build.register("ssd_chunked", CSRC / "ssd_chunked.cu", {
    "ssd_chunked_f32": ([P] * 8 + [I64, I64, INT, INT, INT, P],
                        ctypes.c_int),
    "ssd_chunked_smem_bytes": ([INT, INT], ctypes.c_longlong),
})
MAX_CHUNK = 128               # the kernel's largest chunk
MAX_SMEM = 232_448            # shared memory one block may use on Hopper


def _check(x, loga, dt, Bm, Cm, h0) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan_kernel: tensors must lie on a CUDA "
                         f"device, got {x.device}")
    BH, S, Pw = x.shape
    N = Bm.shape[-1]
    want = {"x": (x, (BH, S, Pw)), "loga": (loga, (BH, S, 1)),
            "dt": (dt, (BH, S, 1)), "Bm": (Bm, (BH, S, N)),
            "Cm": (Cm, (BH, S, N))}
    if h0 is not None:
        want["h0"] = (h0, (BH, N, Pw))
    for name, (t, shape) in want.items():
        if t.dtype != torch.float32:
            raise TypeError(f"ssm_scan_kernel: {name} must be float32, "
                            f"got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"ssm_scan_kernel: {name} must be {shape}, "
                             f"got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"ssm_scan_kernel: all tensors must share "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssm_scan_kernel: {name} must be contiguous")


def ssm_scan_kernel(x: torch.Tensor, loga: torch.Tensor, dt: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
                    h0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (BH, S, P), h_final (BH, N, P)) of the chunked scan with chunks
    of ``min(chunk, S)`` tokens (at most 128 on the card), which must
    divide S."""
    if x.dim() != 3 or Bm.dim() != 3:
        raise ValueError("ssm_scan_kernel: x and Bm must be 3-d")
    _check(x, loga, dt, Bm, Cm, h0)
    BH, S, Pw = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if Q < 1 or Q > MAX_CHUNK or S % Q:
        raise ValueError(f"ssm_scan_kernel: chunk {Q} must be 1..{MAX_CHUNK}"
                         f" and divide the sequence {S}")
    smem = cuda_build.library("ssd_chunked").ssd_chunked_smem_bytes(Pw, N)
    if smem > MAX_SMEM:
        raise ValueError(f"ssm_scan_kernel: N={N} needs {smem} bytes of "
                         f"shared memory, more than {MAX_SMEM}")
    y = torch.empty_like(x)
    h = torch.empty((BH, N, Pw), dtype=torch.float32, device=x.device)
    cuda_build.launch(
        "ssd_chunked", "ssd_chunked_f32", x.device,
        P(x.data_ptr()), P(loga.data_ptr()), P(dt.data_ptr()),
        P(Bm.data_ptr()), P(Cm.data_ptr()),
        P(None if h0 is None else h0.data_ptr()), P(y.data_ptr()),
        P(h.data_ptr()), BH, S, Pw, N, Q)
    ssm_scan_kernel.launches += 1
    return y, h


ssm_scan_kernel.launches = 0

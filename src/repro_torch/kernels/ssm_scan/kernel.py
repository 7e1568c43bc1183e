"""The CUDA kernel of the chunked SSD scan, its build and its wrapper.

``csrc/ssd_chunked.cu`` is the hand-written Hopper (``sm_90a``) port of
the Pallas kernel ``repro/kernels/ssm_scan/kernel.py::ssm_scan_kernel``,
redesigned as a chunk-parallel scan: every (row, chunk) at once computes
its in-chunk cumsum, its masked C B^T and its chunk state, a pass
carries the float32 state across the chunks, and a last stage adds the
carried state's part of ``y``; the products run on the tensor cores in
3xTF32 (the source's header gives the design and its bound).  P = 1,
mLSTM's denominator, runs the recurrence form instead, one thread a
state row.  Unlike the TPU kernel it starts from an optional ``h0`` and
returns the final state, which prefill hands to the decode cache.  It
is built and loaded by :mod:`..cuda_build`.

:func:`ssm_scan_kernel` takes CUDA tensors only (``ops.ssm_scan``
sends CPU tensors to the plain chunked version): it checks device,
dtype, shapes and contiguity, allocates the outputs and the scratch
with ``torch.empty``, launches on the current stream and adds one to
its ``launches`` count.  One call makes four CUDA launches (intra,
states, pass, out), three at P = 1 (vec_states, pass, vec_out), each
checked with ``cudaGetLastError``; the count says calls, not CUDA
launches.  Nothing falls back: a failed build or launch raises.
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
    "ssd_chunked_f32": ([P] * 11 + [I64, I64, INT, INT, INT, P],
                        ctypes.c_int),
})
MAX_CHUNK = 128               # the kernel's largest chunk


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
    NC = S // Q

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=x.device)

    y, h = torch.empty_like(x), empty(BH, N, Pw)
    # scratch: the chunks' cumsums, their states (then the states that
    # enter them) and, off the P = 1 path, their masked C B^T, growing
    # with S: the states take BH S N P / Q x 4 bytes.  Freed on
    # return while the launches may still run: the caching allocator hands
    # the memory only to work queued after them on this same stream
    cum, states = empty(BH, S), empty(BH, NC, N, Pw)
    M = empty(BH, NC, Q, Q) if Pw > 1 else None
    cuda_build.launch(
        "ssd_chunked", "ssd_chunked_f32", x.device,
        *(P(None if t is None else t.data_ptr())
          for t in (x, loga, dt, Bm, Cm, h0, y, h, cum, states, M)),
        BH, S, Pw, N, Q)
    ssm_scan_kernel.launches += 1
    return y, h


ssm_scan_kernel.launches = 0

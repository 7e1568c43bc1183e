"""CUDA kernels for the batched max-plus departure scan, their build and
their wrappers.

Two kernels, both hand-written for Hopper (``sm_90a``) in ``csrc/``:

* ``maxplus_chunked`` (``csrc/maxplus_chunked.cu``) — one warp per row,
  warp-shuffle cumsum and cummax per tile, the carry in a register: the
  port of the Pallas kernel ``repro/kernels/maxplus_scan/kernel.py::
  maxplus_depart_kernel``.
* ``maxplus_seq`` (``csrc/maxplus_seq.cu``) — one thread per row stepping
  ``d = max(a, d) + s`` in the engine's float order, bitwise equal to the
  sequential oracle: what the closed-loop sweep needs.

Both are built and loaded by :mod:`..cuda_build` (one ``nvcc`` per
source, all started together, into ``_build/``), with ``--fmad=false``.

Each wrapper takes CPU tensors to its plain PyTorch version in
``ref.py``; on a CUDA tensor it checks device, dtype, shape and
contiguity, allocates the output, launches on the current stream, checks
the launch, and adds one to its ``launches`` count.  Nothing falls back:
a failed build or launch raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from .. import cuda_build
from ..cuda_build import I64 as _I64, INT as _INT, P as _P
from .ref import maxplus_chunked_ref, maxplus_depart_ref

CSRC = Path(__file__).resolve().parent / "csrc"
_ARGTYPES = {
    "maxplus_chunked": [_P, _P, _P, _P, _I64, _I64, _INT, _P],
    "maxplus_seq": [_P, _P, _P, _P, _P, _I64, _I64, _P],
}
for _name, _args in _ARGTYPES.items():
    cuda_build.register(
        _name, CSRC / f"{_name}.cu",
        {f"{_name}_{dt}": (_args, ctypes.c_int) for dt in ("f64", "f32")},
        flags=("--fmad=false",))
# rows (one warp each) per CTA of maxplus_chunked; the output does not
# depend on it, and it has not been tuned
WARPS_PER_CTA = 8


def _check(name: str, a: torch.Tensor, *others: Optional[torch.Tensor]):
    if a.device.type != "cuda":
        raise ValueError(f"{name}: tensors must lie on a CUDA device, "
                         f"got {a.device}")
    if a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: float32 or float64 only, got {a.dtype}")
    if a.dim() != 2:
        raise ValueError(f"{name}: expects (R, L) tensors, got {a.shape}")
    for t in (a, *others):
        if t is None:
            continue
        if t.device != a.device:
            raise ValueError(f"{name}: all tensors must share {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _row_init(name: str, a: torch.Tensor, init) -> Optional[torch.Tensor]:
    if init is None:
        return None
    x0 = torch.as_tensor(init)
    if x0.dtype != a.dtype or x0.shape != a.shape[:1]:
        raise ValueError(f"{name}: init must be ({a.shape[0]},) {a.dtype}, "
                         f"got {tuple(x0.shape)} {x0.dtype}")
    return x0


def _launch(name: str, wrapper, a: torch.Tensor, *args) -> None:
    dt = "f64" if a.dtype == torch.float64 else "f32"
    cuda_build.launch(name, f"{name}_{dt}", a.device, *args)
    wrapper.launches += 1


def maxplus_chunked(arrive: torch.Tensor, svc: torch.Tensor,
                    init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Departures for (R, L) ``arrive``/``svc``, every row independent,
    each carry starting at ``init[r]`` (or -inf).

    CPU tensors run :func:`~.ref.maxplus_chunked_ref`, chunked at the
    kernel's tile.  CUDA tensors launch the warp-scan kernel with
    ``WARPS_PER_CTA`` warps (one row each) per CTA; any L and R are taken
    as they are.
    """
    if arrive.device.type == "cpu":
        return maxplus_chunked_ref(arrive, svc, init)
    x0 = _row_init("maxplus_chunked", arrive, init)
    _check("maxplus_chunked", arrive, svc, x0)
    if svc.dtype != arrive.dtype or svc.shape != arrive.shape:
        raise ValueError("maxplus_chunked: arrive and svc differ in "
                         "dtype or shape")
    out = torch.empty_like(arrive)
    R, L = arrive.shape
    if out.numel():
        _launch("maxplus_chunked", maxplus_chunked, arrive,
                _P(arrive.data_ptr()), _P(svc.data_ptr()), _P(_ptr(x0)),
                _P(out.data_ptr()), R, L, WARPS_PER_CTA)
    return out


maxplus_chunked.launches = 0


def maxplus_seq(arrive: torch.Tensor, svc: torch.Tensor,
                reset: Optional[torch.Tensor] = None,
                init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact sequential departures for (R, L) ``arrive``/``svc``, bitwise
    equal to :func:`~.ref.maxplus_depart_ref`, which CPU tensors run.
    ``reset`` (bool, (R, L)) restarts a row at an idle leader; ``init``
    ((R,)) is each row's starting carry."""
    if arrive.device.type == "cpu":
        return maxplus_depart_ref(arrive, svc, reset=reset, init=init)
    x0 = _row_init("maxplus_seq", arrive, init)
    rs = None
    if reset is not None:
        rs = torch.as_tensor(reset)
        if rs.dtype != torch.bool or rs.shape != arrive.shape:
            raise ValueError("maxplus_seq: reset must be a bool tensor "
                             "shaped like arrive")
        rs = rs.view(torch.uint8)
    _check("maxplus_seq", arrive, svc, x0, rs)
    if svc.dtype != arrive.dtype or svc.shape != arrive.shape:
        raise ValueError("maxplus_seq: arrive and svc differ in dtype or "
                         "shape")
    out = torch.empty_like(arrive)
    R, L = arrive.shape
    if out.numel():
        _launch("maxplus_seq", maxplus_seq, arrive,
                _P(arrive.data_ptr()), _P(svc.data_ptr()), _P(_ptr(rs)),
                _P(_ptr(x0)), _P(out.data_ptr()), R, L)
    return out


maxplus_seq.launches = 0

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

Each source is compiled by ``nvcc`` into its own shared library with a
plain C interface, loaded with :mod:`ctypes`, at first use (or by
:func:`build`), into ``_build/`` beside the package sources.  The
libraries are named by a hash of source and flags, so an edit rebuilds
and an unchanged source loads at once.

Each wrapper takes CPU tensors to its plain PyTorch version in
``ref.py``; on a CUDA tensor it checks device, dtype, shape and
contiguity, allocates the output, launches on the current stream, checks
the launch, and adds one to its ``launches`` count.  Nothing falls back:
a failed build or launch raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional

import torch

from .ref import maxplus_chunked_ref, maxplus_depart_ref

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
SOURCES = ("maxplus_chunked", "maxplus_seq")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = {
    "maxplus_chunked": [_P, _P, _P, _P, _I64, _I64, _INT, _P],
    "maxplus_seq": [_P, _P, _P, _P, _P, _I64, _I64, _P],
}
# rows (one warp each) per CTA of maxplus_chunked; the output does not
# depend on it, and it has not been tuned
WARPS_PER_CTA = 8
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}   # source -> nvcc's output (ptxas -v)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build() -> Dict[str, ctypes.CDLL]:
    """Compile every source whose library is missing — one ``nvcc`` per
    source, all started together — and load them all."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        if name in _LIBS or _target(name).exists():
            continue
        tmp = _target(name).with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
        os.replace(tmp, _target(name))
    for name in SOURCES:
        if name not in _LIBS:
            lib = ctypes.CDLL(str(_target(name)))
            for dt in ("f64", "f32"):
                fn = getattr(lib, f"{name}_{dt}")
                fn.argtypes = _ARGTYPES[name]
                fn.restype = ctypes.c_int
            err = getattr(lib, f"{name}_error_string")
            err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
            _LIBS[name] = lib
    return _LIBS


def _entry(name: str, dtype: torch.dtype):
    lib = _LIBS.get(name) or build()[name]
    return lib, getattr(lib, f"{name}_{'f64' if dtype == torch.float64 else 'f32'}")


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
    lib, fn = _entry(name, a.dtype)
    with torch.cuda.device(a.device):
        err = fn(*args, _P(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")
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

"""The CUDA kernel of flash attention, its build and its wrapper.

``csrc/flash_fwd.cu`` is the hand-written Hopper (``sm_90a``) port of
the Pallas kernel
``repro/kernels/flash_attention/kernel.py::flash_attention_kernel``:
block online-softmax attention with causal, window and true-length
masks, KV tiles that no query of a tile can reach skipped (the source's
header gives the design and its bound).  Unlike the TPU kernel it reads
the reference's (B, S, heads, hd) layout itself, indexing query head
``h``'s KV head as ``h // (H / K)``, so neither the head fold nor the
GQA repeat is materialized, and it takes the true KV length as a device
int32, so a decode step needs no host sync.  It is built and loaded by
:mod:`..cuda_build`.

:func:`flash_fwd` takes CUDA tensors only (``ops.flash_attention``
sends CPU tensors to the plain chunked version): it checks device,
dtype, shapes and contiguity, allocates the output, launches on the
current stream, checks the launch and adds one to its ``launches``
count.  Nothing falls back: a failed build or launch raises.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional, Union

import torch

from .. import cuda_build
from ..cuda_build import INT, P

CSRC = Path(__file__).resolve().parent / "csrc"
cuda_build.register("flash_fwd", CSRC / "flash_fwd.cu", {
    "flash_fwd_f32": ([P] * 5 + [INT] * 9 + [ctypes.c_float, P],
                      ctypes.c_int),
})
MAX_HD = 128   # the kernel's widest head


def _check(q, k, v, kv_len) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: tensors must lie on a CUDA device, "
                         f"got {q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_fwd: q, k and v must be 4-d")
    B, _, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if H % K:
        raise ValueError(f"flash_fwd: {H} query heads are not a multiple "
                         f"of {K} KV heads")
    if not 1 <= hd <= MAX_HD:
        raise ValueError(f"flash_fwd: head width {hd} not in 1..{MAX_HD}")
    for name, t, shape in (("q", q, tuple(q.shape)),
                           ("k", k, (B, Skv, K, hd)),
                           ("v", v, (B, Skv, K, hd))):
        if t.dtype != torch.float32:
            raise TypeError(f"flash_fwd: {name} must be float32, got "
                            f"{t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"flash_fwd: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"flash_fwd: all tensors must share "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_fwd: {name} must be contiguous")
    if isinstance(kv_len, torch.Tensor) and (
            kv_len.dtype != torch.int32 or kv_len.numel() != 1
            or kv_len.device != q.device):
        raise ValueError(f"flash_fwd: kv_len must be one int32 on "
                         f"{q.device}")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              kv_len: Optional[Union[int, torch.Tensor]] = None
              ) -> torch.Tensor:
    """Attention of q (B, Sq, H, hd) over k, v (B, Skv, K, hd), all
    contiguous float32 on one CUDA device; returns (B, Sq, H, hd).
    ``kv_len``: valid KV entries, an int or a one-element int32 tensor
    on the device (read by the kernel); None or 0 means Skv, as the TPU
    kernel's ``seq_k``."""
    _check(q, k, v, kv_len)
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if window < 0:
        raise ValueError(f"flash_fwd: window {window} < 0")
    o = torch.empty_like(q)
    dev_len = kv_len if isinstance(kv_len, torch.Tensor) else None
    seq_k = Skv if kv_len is None or dev_len is not None else (
        int(kv_len) or Skv)
    cuda_build.launch(
        "flash_fwd", "flash_fwd_f32", q.device,
        P(q.data_ptr()), P(k.data_ptr()), P(v.data_ptr()), P(o.data_ptr()),
        P(None if dev_len is None else dev_len.data_ptr()),
        B, Sq, Skv, H, K, hd, seq_k, int(causal), int(window),
        ctypes.c_float(1.0 / math.sqrt(hd)))
    flash_fwd.launches += 1
    return o


flash_fwd.launches = 0

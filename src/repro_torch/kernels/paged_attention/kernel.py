"""The CUDA kernel of paged decode attention, its build and its wrapper.

``csrc/paged_decode.cu`` is the hand-written Hopper (``sm_90a``) port of
the Pallas kernel
``repro/kernels/paged_attention/kernel.py::paged_attention_kernel``: one
query token per sequence over KV pages found through a page table, by an
online softmax across the pages.  One CTA per (sequence, KV head) (and
block of up to 8 grouped query heads) reads the sequence's length and
table row itself, where the TPU kernel prefetched them as scalars, and
walks only the pages that hold valid positions (the source's header gives
the design and its bound).  It is built and loaded by :mod:`..cuda_build`.

:func:`paged_decode` takes CUDA tensors only (``ops.paged_attention``
sends CPU tensors to the plain online version): it checks device,
dtypes, shapes and contiguity, allocates the output, launches on the
current stream, checks the launch and adds one to its ``launches``
count.  Nothing falls back: a failed build or launch raises.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from .. import cuda_build
from ..cuda_build import INT, P

CSRC = Path(__file__).resolve().parent / "csrc"
cuda_build.register("paged_decode", CSRC / "paged_decode.cu", {
    "paged_decode_f32": ([P] * 6 + [INT] * 7 + [ctypes.c_float, P],
                         ctypes.c_int),
})
MAX_HD = 128   # the kernel's widest head


def _check(q, k_pages, v_pages, page_table, lengths) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode: tensors must lie on a CUDA device, "
                         f"got {q.device}")
    if q.dim() != 4 or k_pages.dim() != 4 or page_table.dim() != 2:
        raise ValueError("paged_decode: q and the pools must be 4-d, the "
                         "page table 2-d")
    B, K, G, hd = q.shape
    N, page = k_pages.shape[1], k_pages.shape[2]
    if not 1 <= hd <= MAX_HD:
        raise ValueError(f"paged_decode: head width {hd} not in 1..{MAX_HD}")
    if N < 1 or page < 1 or page_table.shape[1] < 1:
        raise ValueError("paged_decode: empty pool, page or page table")
    for name, t, shape, dtype in (
            ("q", q, (B, K, G, hd), torch.float32),
            ("k_pages", k_pages, (K, N, page, hd), torch.float32),
            ("v_pages", v_pages, (K, N, page, hd), torch.float32),
            ("page_table", page_table, (B, page_table.shape[1]), torch.int32),
            ("lengths", lengths, (B,), torch.int32)):
        if t.dtype != dtype:
            raise TypeError(f"paged_decode: {name} must be {dtype}, got "
                            f"{t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"paged_decode: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"paged_decode: all tensors must share "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_decode: {name} must be contiguous")


def paged_decode(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, page_table: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention of q (B, K, G, hd) over the pools k_pages, v_pages
    (K, N, page, hd) through ``page_table`` (B, P_max) and ``lengths``
    (B,), both int32; all contiguous, float32 but the tables, on one CUDA
    device.  Returns (B, K, G, hd).  Table entries of pages past a
    sequence's length are never read."""
    _check(q, k_pages, v_pages, page_table, lengths)
    B, K, G, hd = q.shape
    _, N, page, _ = k_pages.shape
    o = torch.empty_like(q)
    cuda_build.launch(
        "paged_decode", "paged_decode_f32", q.device,
        P(q.data_ptr()), P(k_pages.data_ptr()), P(v_pages.data_ptr()),
        P(page_table.data_ptr()), P(lengths.data_ptr()), P(o.data_ptr()),
        B, K, G, hd, N, page, page_table.shape[1],
        ctypes.c_float(1.0 / math.sqrt(hd)))
    paged_decode.launches += 1
    return o


paged_decode.launches = 0

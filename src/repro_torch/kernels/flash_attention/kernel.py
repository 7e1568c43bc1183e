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

Two launch configurations, by the number of queries: prefill (Sq > 4)
tiles of queries on the tensor cores; decode (Sq <= 4) one CTA cluster
per (sequence, KV head) whose ``decode_splits`` CTAs split the keys,
each serving the whole query group from one read of K and V, the splits
merged through the cluster's shared memory within the one launch.  A
decode call reads the valid K and V once, which bounds it (0.0502 ms for
stablelm-3b's 8 x 1025 tokens at 3.35 TB/s).

The int8 decode cache has an instance of its own of the decode
configuration (entry ``flash_fwd_decode_i8``), still one launch: K and
V int8, each row (token, KV head) with one float32 scale in
``kv_scales`` (B, Skv, K, 1), the reference's ``_quant_kv`` layout.
Each warp copies its next steps' codes and scales by ``cp.async`` into
a ring of its own in shared memory, several steps in flight while it
scores one, ``decode_copy_bytes`` bytes a copy; it dequantizes from the
ring (``float(code) * scale``, the reference's rounding) into the float
instance's arithmetic, so its output is bitwise the float instance's
over the dequantized copy at the same split count, and no float copy of
the cache is made.  Its bound is (hd + 4) bytes a K or V row (0.0132 ms
at stablelm-3b's).  The prefill (tile) configuration takes no int8: an
int8 call with more than ``DECODE_MAX_SQ`` queries raises.

:func:`flash_fwd` takes CUDA tensors only (``ops.flash_attention``
sends CPU tensors to the plain chunked version): it checks device,
dtype, shapes and contiguity, allocates the output, launches on the
current stream, checks the launch and adds one to its ``launches``
count.  Nothing falls back: a failed build or launch raises.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Optional, Tuple, Union

import torch

from .. import cuda_build
from ..cuda_build import INT, P

CSRC = Path(__file__).resolve().parent / "csrc"
cuda_build.register("flash_fwd", CSRC / "flash_fwd.cu", {
    "flash_fwd_f32": ([P] * 5 + [INT] * 10 + [ctypes.c_float, P],
                      ctypes.c_int),
    "flash_fwd_decode_i8": ([P] * 7 + [INT] * 11 + [ctypes.c_float, P],
                            ctypes.c_int),
})
MAX_HD = 128   # the kernel's widest head
DECODE_MAX_SQ = 4   # queries at or below which the decode configuration runs
TILE = 64      # keys of a KV tile
MAX_SPLIT = 8  # the portable cluster size


@functools.lru_cache(maxsize=None)
def decode_splits(bk: int, rows: int, skv: int, sms: int) -> int:
    """CTAs of the decode configuration's cluster for ``bk`` (sequence, KV
    head) pairs of ``rows`` = G Sq query rows over a cache of ``skv``
    slots on ``sms`` SMs.  The grid has a cluster per pair and pass of
    rows (one pass up to 4 rows, passes of 8 above, as flash_fwd.cu
    dispatches); the splits are the largest power of two that keeps its
    CTAs within one an SM, capped at ``MAX_SPLIT`` and at one 64-key tile
    of the cache a split, and at least 1.  It reads the cache's size, not
    the valid length, so a call needs no host sync; splits whose tiles lie
    past the valid length load nothing."""
    clusters = bk * (1 if rows <= 4 else -(-rows // 8))
    tiles = -(-skv // TILE)
    n = 1
    while 2 * n <= MAX_SPLIT and 2 * n <= tiles and clusters * 2 * n <= sms:
        n *= 2
    return n


@functools.lru_cache(maxsize=None)
def int8_decode_splits(bk: int, rows: int, skv: int, sms: int) -> int:
    """``decode_splits`` for the int8 instance.  Its one-row passes hold
    their keys in flight in the shared-memory ring, not in registers,
    and are bounded for two CTAs an SM, so there the splits may fill the
    SMs twice over (seamless-m4t-large-v2's decoder: 2 splits, not 1);
    passes of more rows keep the float instance's rule, whose split
    counts measured fastest for them too (``decode_sweep.py``; PERF.md).
    Like it, it reads the cache's size, never the valid length."""
    return decode_splits(bk, rows, skv, 2 * sms if rows == 1 else sms)


def decode_copy_bytes(hd: int, *addresses: int) -> int:
    """Bytes of one ``cp.async`` of the int8 instance's codes: 16 where it
    divides the head width ``hd`` (so every row of the cache starts at a
    multiple of it) and each of the code tensors' ``addresses``, else 4
    where that does; 1 where neither does, and the lanes then copy a byte
    each."""
    for n in (16, 4):
        if hd % n == 0 and all(a % n == 0 for a in addresses):
            return n
    return 1


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_groups(H: int, K: int) -> None:
    """Raise unless the ``H`` query heads form whole groups over the ``K``
    KV heads: a KV-head padding can leave them uneven (phi3-medium-14b at
    tp 8, 40 over 16), and neither the kernel nor its plain version may
    run on a floored group."""
    if H % K:
        raise ValueError(f"flash_fwd: {H} query heads are not a multiple "
                         f"of {K} KV heads")


def _check(q, k, v, kv_len, kv_scales=None) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: tensors must lie on a CUDA device, "
                         f"got {q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_fwd: q, k and v must be 4-d")
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    check_groups(H, K)
    if not 1 <= hd <= MAX_HD:
        raise ValueError(f"flash_fwd: head width {hd} not in 1..{MAX_HD}")
    kv_dtype = torch.float32 if kv_scales is None else torch.int8
    if kv_scales is not None:
        if Sq > DECODE_MAX_SQ:
            raise ValueError(f"flash_fwd: int8 K/V take the decode "
                             f"configuration only, Sq <= {DECODE_MAX_SQ}; "
                             f"got {Sq}")
        if len(kv_scales) != 2:
            raise ValueError("flash_fwd: kv_scales must be (k_scale, "
                             "v_scale)")
    tensors = [("q", q, tuple(q.shape), torch.float32),
               ("k", k, (B, Skv, K, hd), kv_dtype),
               ("v", v, (B, Skv, K, hd), kv_dtype)]
    if kv_scales is not None:
        tensors += [(name, t, (B, Skv, K, 1), torch.float32)
                    for name, t in zip(("k_scale", "v_scale"), kv_scales)]
    for name, t, shape, dtype in tensors:
        if t.dtype != dtype:
            raise TypeError(f"flash_fwd: {name} must be {dtype}, got "
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
              kv_len: Optional[Union[int, torch.Tensor]] = None,
              kv_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> torch.Tensor:
    """Attention of q (B, Sq, H, hd) over k, v (B, Skv, K, hd), all
    contiguous float32 on one CUDA device; returns (B, Sq, H, hd).
    ``kv_len``: valid KV entries, an int or a one-element int32 tensor
    on the device (read by the kernel); None or 0 means Skv, as the TPU
    kernel's ``seq_k``.  ``kv_scales``: (k_scale, v_scale), contiguous
    float32 (B, Skv, K, 1), with int8 k and v and Sq <= 4: the int8
    decode instance."""
    _check(q, k, v, kv_len, kv_scales)
    if window < 0:
        raise ValueError(f"flash_fwd: window {window} < 0")
    B, Sq, H, _ = q.shape
    Skv, K = k.shape[1], k.shape[2]
    rule = decode_splits if kv_scales is None else int8_decode_splits
    n_split = (rule(B * K, H // K * Sq, Skv, _sm_count(q.device.index or 0))
               if Sq <= DECODE_MAX_SQ else 1)
    o = _launch(q, k, v, causal, window, kv_len, n_split, kv_scales)
    flash_fwd.launches += 1
    return o


def _launch(q, k, v, causal: bool, window: int, kv_len,
            n_split: int, kv_scales=None) -> torch.Tensor:
    """One launch of the kernel on checked inputs, the decode
    configuration split ``n_split`` ways (the int8 instance with
    ``kv_scales``); counts nothing (``flash_fwd`` does, and
    ``decode_sweep`` times other splits through this)."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    dev_len = kv_len if isinstance(kv_len, torch.Tensor) else None
    seq_k = Skv if kv_len is None or dev_len is not None else (
        int(kv_len) or Skv)
    ptrs = [P(q.data_ptr()), P(k.data_ptr()), P(v.data_ptr())]
    ints = [B, Sq, Skv, H, K, hd, seq_k, int(causal), int(window), n_split]
    if kv_scales is not None:
        ptrs += [P(t.data_ptr()) for t in kv_scales]
        ints.append(decode_copy_bytes(hd, k.data_ptr(), v.data_ptr()))
    cuda_build.launch(
        "flash_fwd", "flash_fwd_f32" if kv_scales is None
        else "flash_fwd_decode_i8", q.device,
        *ptrs, P(o.data_ptr()),
        P(None if dev_len is None else dev_len.data_ptr()), *ints,
        ctypes.c_float(1.0 / math.sqrt(hd)))
    return o


flash_fwd.launches = 0

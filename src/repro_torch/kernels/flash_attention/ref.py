"""Plain PyTorch versions of flash attention, in the kernel's
head-folded layout: q (BH, Sq, hd), k and v (BH, Skv, hd), softmax
statistics and sums in float32 whatever the input type.

* :func:`flash_attention_ref` — naive masked softmax over the whole
  score matrix, the oracle (``repro/kernels/flash_attention/ref.py``).
* :func:`flash_attention_chunked_ref` — the online softmax over KV
  chunks that the kernel computes (the algorithm of
  ``repro/models/attention.py::gqa_attention``), with the kernel's
  64-key tiles.  CPU tensors run it in place of the kernel.

Both take an int8 K/V with ``kv_scales``, each (BH, Skv, 1) float32,
and dequantize it first as the reference's int8 cache does (the codes
as float32 times their row's scale, ``k_cache.astype(f32) * ksc``).

Masks, as in the TPU kernel: causal ``k_pos <= q_pos``, window
``k_pos > q_pos - window``, true lengths ``k_pos < seq_k`` and ``q_pos <
seq_q`` (0 means the full length; ``seq_k`` may be a 0-d integer tensor,
the decode cache's valid length).  A query with no visible key gives 0.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

NEG_INF = -1e30   # finite: a fully masked row must not give exp(-inf + inf)
CHUNK = 64        # the kernel's KV tile
Length = Union[int, torch.Tensor]
Scales = Optional[Tuple[torch.Tensor, torch.Tensor]]


def _dequant(k: torch.Tensor, v: torch.Tensor, kv_scales: Scales):
    if kv_scales is None:
        return k, v
    return k.float() * kv_scales[0], v.float() * kv_scales[1]


def _mask(Sq: int, k_pos: torch.Tensor, *, causal: bool, window: int,
          seq_q: Length, seq_k: Length) -> torch.Tensor:
    """(Sq, len(k_pos)) bool: which keys each query sees."""
    q_pos = torch.arange(Sq, device=k_pos.device)[:, None]
    k_pos = k_pos[None, :]
    mask = (k_pos < seq_k) & (q_pos < seq_q)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        seq_q: Length = 0, seq_k: Length = 0,
                        kv_scales: Scales = None) -> torch.Tensor:
    """Naive softmax attention over the whole (Sq, Skv) score matrix."""
    k, v = _dequant(k, v, kv_scales)
    BH, Sq, hd = q.shape
    Skv = k.shape[1]
    mask = _mask(Sq, torch.arange(Skv, device=q.device), causal=causal,
                 window=window, seq_q=seq_q or Sq, seq_k=_len(seq_k, Skv))
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(hd)
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.where(mask[None], torch.softmax(s, dim=-1), 0.0)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def flash_attention_chunked_ref(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, causal: bool = True,
                                window: int = 0, seq_q: Length = 0,
                                seq_k: Length = 0, kv_scales: Scales = None
                                ) -> torch.Tensor:
    """Online softmax over KV chunks of ``CHUNK`` keys, carrying the row
    max ``m``, the row sum ``l`` and the unnormalized output ``acc``."""
    k, v = _dequant(k, v, kv_scales)
    BH, Sq, hd = q.shape
    Skv = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    seq_q, seq_k = seq_q or Sq, _len(seq_k, Skv)
    qf = q.float()
    m = torch.full((BH, Sq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((BH, Sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((BH, Sq, hd), dtype=torch.float32, device=q.device)
    for k0 in range(0, Skv, CHUNK):
        kc = k[:, k0:k0 + CHUNK].float()
        vc = v[:, k0:k0 + CHUNK].float()
        mask = _mask(Sq, torch.arange(k0, k0 + kc.shape[1], device=q.device),
                     causal=causal, window=window, seq_q=seq_q, seq_k=seq_k)
        s = torch.einsum("bqd,bkd->bqk", qf, kc) * scale
        s = torch.where(mask[None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        # select after the shift: a row with no visible key yet has
        # s == m_new == NEG_INF, and exp(0) would weigh it 1
        p = torch.where(mask[None], torch.exp(s - m_new), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bqk,bkd->bqd", p, vc)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def _len(seq_k: Length, Skv: int) -> Length:
    """The true KV length; a tensor is used as it is (no host sync)."""
    if isinstance(seq_k, torch.Tensor):
        return seq_k
    return seq_k or Skv

"""Entry point of flash attention: the reference's (B, S, heads, hd)
layout, grouped-query heads, on the device its tensors lie on, with its
gradient.

The forward is the ``flash_fwd`` CUDA kernel on the GPU and the plain
chunked version on the CPU; :class:`FlashAttention` gives it a backward
written out in torch ops (the reference trains through autodiff of plain
``jnp`` and has no backward kernel).  Under ``torch.no_grad()`` only the
forward runs.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch

from .kernel import flash_fwd
from .ref import NEG_INF, _len, _mask, flash_attention_chunked_ref

Length = Optional[Union[int, torch.Tensor]]


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, window: int, kv_len: Length) -> torch.Tensor:
    if q.device.type != "cpu":
        return flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                         causal=causal, window=window, kv_len=kv_len)
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K

    def fold(t, reps):      # (B, S, n, hd) -> (B * n * reps, S, hd)
        t = t.transpose(1, 2)
        if reps > 1:
            t = t.repeat_interleave(reps, dim=1)
        return t.reshape(-1, t.shape[2], hd)

    out = flash_attention_chunked_ref(
        fold(q, 1), fold(k, G), fold(v, G), causal=causal, window=window,
        seq_k=0 if kv_len is None else kv_len)
    return out.reshape(B, H, Sq, hd).transpose(1, 2)


def attention_grads(q, k, v, o, do, *, causal: bool = True,
                    window: int = 0, kv_len: Length = None):
    """dq, dk, dv of softmax attention from its output ``o`` and the
    output's gradient ``do``, in float32 torch ops; shapes as
    :func:`flash_attention`.  The probabilities are recomputed under the
    forward's masks (``ref._mask``): S = q kᵀ / √hd, P = softmax(S) with
    the hidden entries selected away (never multiplied by a 0/1 mask, as
    their exponentials may be inf), D = rowsum(dO ∘ O), dV = Pᵀ dO, dS =
    P ∘ (dO Vᵀ − D), dQ = dS K / √hd, dK = dSᵀ Q / √hd; dK and dV are
    summed over the G query heads that read each KV head."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)

    def heads(t, n):        # (B, S, n * G', hd) -> (B, K, G', S, hd)
        return t.float().permute(0, 2, 1, 3).reshape(B, K, n, -1, hd)

    qh, oh, doh = heads(q, G), heads(o, G), heads(do, G)
    kh, vh = heads(k, 1)[:, :, 0], heads(v, 1)[:, :, 0]   # (B, K, Skv, hd)
    mask = _mask(Sq, torch.arange(Skv, device=q.device), causal=causal,
                 window=window, seq_q=Sq,
                 seq_k=_len(0 if kv_len is None else kv_len, Skv))
    s = torch.einsum("bkgqd,bktd->bkgqt", qh, kh) * scale
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    p = torch.where(mask, p, 0.0)
    del s
    dv = torch.einsum("bkgqt,bkgqd->bktd", p, doh)
    dp = torch.einsum("bkgqd,bktd->bkgqt", doh, vh)
    ds = p * (dp - (doh * oh).sum(-1, keepdim=True))
    del p, dp
    dq = torch.einsum("bkgqt,bktd->bkgqd", ds, kh) * scale
    dk = torch.einsum("bkgqt,bkgqd->bktd", ds, qh) * scale

    def back(t):            # (B, K, G', S, hd) -> (B, S, K * G', hd)
        return t.reshape(B, -1, t.shape[-2], hd).transpose(1, 2)

    return (back(dq).to(q.dtype), back(dk).to(k.dtype),
            back(dv).to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """Flash attention with a gradient: the forward as above (the kernel
    on the GPU, never the plain version there), the backward
    :func:`attention_grads` from the saved q, k, v and the forward's
    output."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, kv_len: Length):
        o = _forward(q, k, v, causal, window, kv_len)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.window, ctx.kv_len = causal, window, kv_len
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = attention_grads(q, k, v, o, do, causal=ctx.causal,
                                     window=ctx.window, kv_len=ctx.kv_len)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    kv_len: Length = None) -> torch.Tensor:
    """q (B, Sq, H, hd); k, v (B, Skv, K, hd) with H % K == 0 (GQA: query
    head h reads KV head h // (H / K)).  Returns (B, Sq, H, hd).

    ``kv_len``: the number of valid KV entries (the decode cache's true
    length, the TPU kernel's ``seq_k``), an int or a 0-d int32 tensor on
    the tensors' device, so that a decode step passes it without a host
    sync; None (or 0, as the TPU kernel's ``seq_k``) means all Skv.

    CPU tensors run the plain chunked version on head-folded copies; any
    other tensors go to the ``flash_fwd`` CUDA kernel, which indexes the
    KV head itself and raises off a CUDA device.  There is no other
    fallback.  Differentiable in q, k and v through
    :class:`FlashAttention`.
    """
    return FlashAttention.apply(q, k, v, causal, window, kv_len)

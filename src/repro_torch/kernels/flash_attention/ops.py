"""Entry point of flash attention: the reference's (B, S, heads, hd)
layout, grouped-query heads, on the device its tensors lie on."""
from __future__ import annotations

from typing import Optional, Union

import torch

from .kernel import flash_fwd
from .ref import flash_attention_chunked_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    kv_len: Optional[Union[int, torch.Tensor]] = None
                    ) -> torch.Tensor:
    """q (B, Sq, H, hd); k, v (B, Skv, K, hd) with H % K == 0 (GQA: query
    head h reads KV head h // (H / K)).  Returns (B, Sq, H, hd).

    ``kv_len``: the number of valid KV entries (the decode cache's true
    length, the TPU kernel's ``seq_k``), an int or a 0-d int32 tensor on
    the tensors' device, so that a decode step passes it without a host
    sync; None (or 0, as the TPU kernel's ``seq_k``) means all Skv.

    CPU tensors run the plain chunked version on head-folded copies; any
    other tensors go to the ``flash_fwd`` CUDA kernel, which indexes the
    KV head itself and raises off a CUDA device.  There is no other
    fallback.
    """
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

"""Grouped-query attention, the counterpart of
``repro/models/attention.py`` for the dense family.

Every attention call goes through ``kernels/flash_attention``: the
hand-written ``flash_fwd`` CUDA kernel on the GPU, its plain chunked
online-softmax version on the CPU.  Prefill is causal self-attention
(:func:`attn_apply`); decode attends one new token over the cache's
valid prefix (:func:`decode_attention`: ``causal=False`` and the true
length ``kv_len``, the TPU kernel's ``seq_k``).

Not ported: the int8 KV cache (``kv_scales``, ROADMAP section 1 item 4),
which the serve path does not use; cross-attention (the audio family).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import NEG_INF
from .layers import apply_rope, dense_init

Params = Dict[str, torch.Tensor]

__all__ = ["NEG_INF", "attn_apply", "attn_init", "decode_attention",
           "gqa_attention"]


def attn_init(gen: torch.Generator, d_model: int, n_heads: int, n_kv: int,
              hd: int, dtype: torch.dtype = torch.float32) -> Params:
    return {
        "wq": dense_init(gen, (d_model, n_heads * hd), dtype),
        "wk": dense_init(gen, (d_model, n_kv * hd), dtype),
        "wv": dense_init(gen, (d_model, n_kv * hd), dtype),
        "wo": dense_init(gen, (n_heads * hd, d_model), dtype),
    }


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, Sq, H, hd); k, v (B, Skv, K, hd); H % K == 0.  ``kv_len``:
    the number of valid KV entries (a 0-d int32 tensor on the device, so
    decode passes it without a host sync).  Returns (B, Sq, H, hd)."""
    return flash_attention(q, k, v, causal=causal, window=window,
                           kv_len=kv_len)


def attn_apply(p: Params, x: torch.Tensor, *, n_heads: int, n_kv: int,
               hd: int, rope_theta: float, causal: bool = True,
               window: int = 0, positions: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Self-attention sub-layer: projections, RoPE on q and k, flash
    attention, output projection.  Returns (out (B, S, D), k, v), with k
    (after RoPE) and v (B, S, K, hd) as the decode cache stores them: the
    reference's prefill projects them a second time for the cache, the
    port keeps these (the same numbers)."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, n_heads, hd)
    k = (x @ p["wk"]).reshape(B, S, n_kv, hd)
    v = (x @ p["wv"]).reshape(B, S, n_kv, hd)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, torch.arange(S, device=x.device)[None, :], rope_theta)
    out = gqa_attention(q, k, v, causal=causal, window=window)
    return out.reshape(B, S, n_heads * hd) @ p["wo"], k, v


def decode_attention(p: Params, x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_len: torch.Tensor, *,
                     n_heads: int, n_kv: int, hd: int, rope_theta: float,
                     window: int = 0, kv_scales=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode: write the token's K/V into the cache, attend over
    the valid prefix.

    x (B, 1, D); caches (B, S_max, K, hd); ``cur_len``: 0-d int32 tensor,
    the valid entries *before* this token.  The new entry goes to slot
    ``cur_len`` (``cur_len % S_max`` under a sliding window: a ring
    buffer; the last slot once a cache without a window is full, and
    the token still attends over ``S_max`` entries).  **The caches are
    updated in place** (the reference returns new arrays): the step
    writes one slot of a cache that is gigabytes at full width.  Returns (out (B, 1, D), k_cache, v_cache), the caches
    being the same tensors that were passed in.
    """
    if kv_scales is not None:
        raise NotImplementedError(
            "int8 KV cache (kv_scales) is not ported yet (ROADMAP.md, "
            "section 1 item 4)")
    B = x.shape[0]
    S_max = k_cache.shape[1]
    q = (x @ p["wq"]).reshape(B, 1, n_heads, hd)
    k = (x @ p["wk"]).reshape(B, 1, n_kv, hd)
    v = (x @ p["wv"]).reshape(B, 1, n_kv, hd)
    pos = cur_len.reshape(1, 1).expand(B, 1)
    q = apply_rope(q, pos, rope_theta)
    k = apply_rope(k, pos, rope_theta)
    # a full cache without a window overwrites its last slot, as the
    # reference's dynamic_update_slice clamps its start: index_copy_ would
    # raise (a device assert on CUDA) at slot S_max
    slot = (cur_len % S_max if window
            else torch.clamp(cur_len, max=S_max - 1)).reshape(1).long()
    k_cache.index_copy_(1, slot, k.to(k_cache.dtype))
    v_cache.index_copy_(1, slot, v.to(v_cache.dtype))
    out = gqa_attention(q, k_cache.to(q.dtype), v_cache.to(q.dtype),
                        causal=False,
                        kv_len=torch.clamp(cur_len + 1, max=S_max))
    return out.reshape(B, 1, n_heads * hd) @ p["wo"], k_cache, v_cache

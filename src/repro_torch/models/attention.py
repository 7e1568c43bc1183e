"""Grouped-query attention, the counterpart of
``repro/models/attention.py``.

Every attention call goes through ``kernels/flash_attention``: the
hand-written ``flash_fwd`` CUDA kernel on the GPU, its plain chunked
online-softmax version on the CPU.  Prefill is self-attention, causal
in a decoder and not in the audio family's encoder, or cross-attention
over an encoder's output (:func:`attn_apply` with ``kv_x``: no RoPE on
either side, no mask); decode attends one new token over the cache's
valid prefix (:func:`decode_attention`: ``causal=False`` and the true
length ``kv_len``, the TPU kernel's ``seq_k``), and in the audio family
over the encoder's K/V as well (:func:`cross_attention`).

The int8 KV cache: :func:`_quant_kv` quantizes each (token, KV head) row
symmetrically to int8 codes and one float32 scale, as the reference
does; :func:`decode_attention` with ``kv_scales`` writes the new token's
codes and scales and attends over the int8 cache, which the ``flash_fwd``
kernel's decode configuration reads as it is (codes and scales,
dequantized in registers) and the plain version dequantizes first.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import NEG_INF, Scales
from . import spmd
from .layers import apply_rope, dense_init, linear

Params = Dict[str, torch.Tensor]

__all__ = ["NEG_INF", "attn_apply", "attn_init", "cross_attention",
           "decode_attention", "gqa_attention"]


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
                  kv_len: Optional[torch.Tensor] = None,
                  kv_scales: Scales = None) -> torch.Tensor:
    """q (B, Sq, H, hd); k, v (B, Skv, K, hd); H % K == 0.  ``kv_len``:
    the number of valid KV entries (a 0-d int32 tensor on the device, so
    decode passes it without a host sync).  ``kv_scales``: the (B, Skv,
    K, 1) float32 scales of int8 ``k`` and ``v``.  Returns (B, Sq, H,
    hd).  DTensors attend on each device's shards
    (:func:`.spmd.attention`)."""
    if spmd.is_dtensor(q):
        return spmd.attention(q, k, v, causal=causal,
                              window=window, kv_len=kv_len,
                              kv_scales=kv_scales)
    return flash_attention(q, k, v, causal=causal, window=window,
                           kv_len=kv_len, kv_scales=kv_scales)


def _heads(x: torch.Tensor, w: torch.Tensor, n: int,
           hd: int) -> torch.Tensor:
    """``x @ w`` (B, S, n hd) as (B, S, n, hd); a DTensor weight whose
    heads do not divide the model axis projects onto every head on each
    device (:func:`.spmd.project`)."""
    if spmd.is_dtensor(w) and not spmd.splits_heads(w, n):
        y = spmd.project(x, w)
    else:
        y = linear(x, w)
    return y.reshape(x.shape[0], x.shape[1], n, hd)


def attn_apply(p: Params, x: torch.Tensor, *, n_heads: int, n_kv: int,
               hd: int, rope_theta: float, causal: bool = True,
               window: int = 0, positions: Optional[torch.Tensor] = None,
               kv_x: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention sub-layer: projections, RoPE on q and k, flash
    attention, output projection.  With ``kv_x`` (B, Skv, D), the
    cross-attention of the audio family's decoder: K and V are projected
    from it, neither side takes RoPE and no query is masked
    (``causal`` is ignored).  Returns (out (B, S, D), k, v), with k
    (after RoPE, if any) and v (B, Skv, K, hd) as the decode cache
    stores them: the reference's prefill projects them a second time for
    the cache, the port keeps these (the same numbers)."""
    B, S, _ = x.shape
    src = x if kv_x is None else kv_x
    Skv = src.shape[1]
    q = _heads(x, p["wq"], n_heads, hd)
    k = _heads(src, p["wk"], n_kv, hd)
    v = _heads(src, p["wv"], n_kv, hd)
    if kv_x is None:
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :]
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, torch.arange(Skv, device=x.device)[None, :],
                       rope_theta)
    out = gqa_attention(q, k, v, causal=causal and kv_x is None,
                        window=window)
    return linear(out.reshape(B, S, n_heads * hd), p["wo"]), k, v


def cross_attention(p: Params, x: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, *, n_heads: int, hd: int
                    ) -> torch.Tensor:
    """A decode step's cross-attention: x (B, Sq, D) attends over the
    encoder's K/V (B, S_enc, K, hd) that prefill stored, every frame
    valid; the query takes no RoPE.  Returns (B, Sq, D)."""
    B, S, _ = x.shape
    q = _heads(x, p["wq"], n_heads, hd)
    out = gqa_attention(q, k, v, causal=False)
    return linear(out.reshape(B, S, n_heads * hd), p["wo"])


@functools.lru_cache(maxsize=None)
def _code_max(device: torch.device) -> torch.Tensor:
    """127 as a 0-d float32 tensor on ``device``, made once: CUDA divides
    by a Python scalar (or a CPU one) as a product with its reciprocal,
    one rounding off the CPU's and the reference's scale."""
    return torch.tensor(127.0, device=device)


def _quant_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of each (token, head) row of K or V
    entries, the reference's to the bit: ``scale = max(amax, 1e-6) /
    127`` over the last axis in float32, codes ``clip(round(x / scale),
    -127, 127)`` by a true division (never a product with the
    reciprocal) and round-half-to-even, as ``jnp.round``.  Returns (int8
    codes, float32 scales with a trailing 1)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # a DTensor (the dry run's fake tensors) takes a 127 of its own: the
    # cached one is a real tensor of the device
    code_max = (torch.tensor(127.0) if spmd.is_dtensor(amax)
                else _code_max(amax.device))
    scale = torch.clamp_min(amax, 1e-6) / code_max
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _write(cache: torch.Tensor, slot: torch.Tensor,
           src: torch.Tensor) -> None:
    """``cache[:, slot] = src``, in place; a DTensor cache on each
    device's shard (:func:`.spmd.write_slot`)."""
    if spmd.is_dtensor(cache):
        spmd.write_slot(cache, slot, src)
    else:
        cache.index_copy_(1, slot, src)


def decode_attention(p: Params, x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_len: torch.Tensor, *,
                     n_heads: int, n_kv: int, hd: int, rope_theta: float,
                     window: int = 0, kv_scales: Scales = None):
    """One-token decode: write the token's K/V into the cache, attend over
    the valid prefix.

    x (B, 1, D); caches (B, S_max, K, hd); ``cur_len``: 0-d int32 tensor,
    the valid entries *before* this token.  The new entry goes to slot
    ``cur_len`` (``cur_len % S_max`` under a sliding window: a ring
    buffer; the last slot once a cache without a window is full, and
    the token still attends over ``S_max`` entries).  **The caches are
    updated in place** (the reference returns new arrays): the step
    writes one slot of a cache that is gigabytes at full width.  Returns
    (out (B, 1, D), k_cache, v_cache), the caches being the same tensors
    that were passed in.

    ``kv_scales``: (k_scale, v_scale), each (B, S_max, K, 1) float32, for
    an int8 cache.  The token's K and V (after RoPE) are quantized by
    :func:`_quant_kv` and their codes and scales written at the slot, in
    place, and attention reads the int8 cache with its scales.  Returns
    (out, k_cache, v_cache, (k_scale, v_scale)), as the reference does.
    """
    quant = kv_scales is not None
    if (k_cache.dtype == torch.int8) != quant:
        raise ValueError(f"decode_attention: a {k_cache.dtype} cache "
                         + ("takes no kv_scales" if quant else
                            "needs its kv_scales"))
    B = x.shape[0]
    S_max = k_cache.shape[1]
    q = _heads(x, p["wq"], n_heads, hd)
    k = _heads(x, p["wk"], n_kv, hd)
    v = _heads(x, p["wv"], n_kv, hd)
    pos = cur_len.reshape(1, 1).expand(B, 1)
    q = apply_rope(q, pos, rope_theta)
    k = apply_rope(k, pos, rope_theta)
    # a full cache without a window overwrites its last slot, as the
    # reference's dynamic_update_slice clamps its start: index_copy_ would
    # raise (a device assert on CUDA) at slot S_max
    slot = (cur_len % S_max if window
            else torch.clamp(cur_len, max=S_max - 1)).reshape(1).long()
    kv_len = torch.clamp(cur_len + 1, max=S_max)
    if quant:
        (k8, ks), (v8, vs) = _quant_kv(k), _quant_kv(v)
        for dst, src in zip((k_cache, v_cache, *kv_scales), (k8, v8, ks, vs)):
            _write(dst, slot, src)
        out = gqa_attention(q, k_cache, v_cache, causal=False, kv_len=kv_len,
                            kv_scales=kv_scales)
        return (linear(out.reshape(B, 1, n_heads * hd), p["wo"]), k_cache,
                v_cache, kv_scales)
    _write(k_cache, slot, k.to(k_cache.dtype))
    _write(v_cache, slot, v.to(v_cache.dtype))
    out = gqa_attention(q, k_cache.to(q.dtype), v_cache.to(q.dtype),
                        causal=False, kv_len=kv_len)
    return (linear(out.reshape(B, 1, n_heads * hd), p["wo"]), k_cache,
            v_cache)

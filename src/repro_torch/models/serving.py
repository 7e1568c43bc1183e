"""Serving entry points: cache construction, prefill, single-token
decode — the counterparts of ``repro/models/serving.py`` for the dense,
MoE, VLM, audio, hybrid and SSM families.

Cache keys and shapes are the reference's (B = batch, L = layers):

  dense, MoE, VLM, audio:
          k, v (L, B, S, K, hd)           float32; S = max_len, or the
                                          sliding window (a ring buffer);
                                          int8 codes with
                                          ``kv_dtype="int8"``
          ks, vs (L, B, S, K, 1)          the int8 cache's float32 scale
                                          of each (token, KV head) row,
                                          initialised to 1 (int8 only)
  audio:  xk, xv (L, B, S_enc, K, hd)     each decoder layer's
                                          cross-attention K/V over the
                                          encoder's output (S_enc
                                          frames), written by prefill
  hybrid: conv (L, B, ck-1, C)            Mamba2's last ck-1 conv inputs
                                          (ck = conv width, C = d_in +
                                          2 N)
          ssm (L, B, H, N, 64)            Mamba2's SSD states (float32)
          ak, av (L // k, B, S, K, hd)    the shared attention block's
                                          K/V at each of its L // k
                                          applications (k =
                                          shared_attn_every)
  SSM:    m_num (Lm, B*nh, 1, hd2, hd2)   mLSTM numerator states (float32)
          m_den (Lm, B*nh, 1, hd2, 1)     mLSTM denominator states
          s_h, s_c, s_n (Ls, B, D)        sLSTM states
          (nh = heads, hd2 = 2 * d_model / nh, Lm / Ls = mLSTM / sLSTM
          layers)
  all:    len ()                          tokens seen (int32, on the
                                          model's device)

:func:`prefill` returns a new cache.  :func:`decode_step` returns a new
cache dict.  The SSM family's states in it are new tensors and the
cache it was given stays as it was; the dense, MoE, VLM, audio and
hybrid caches are written **in place** (one slot a step of K/V caches that are
gigabytes at full width, and the hybrid's per-layer states beside
them), so the returned dict shares them with the given one.  The valid length stays
on the device: a decode step reads it without a host sync.  Both run
without autograd.

The MoE family routes tokens as the reference does: a prefill groups
them per sequence at the config's ``capacity_factor``, a decode step the
whole batch as one group at ``max(capacity_factor, 2.0)``; ``dispatch``
("einsum", the default, or "sort") picks the layer's dispatch.

The int8 KV cache (``init_cache(..., kv_dtype="int8")``) is the
reference's: the self-attention K/V of the dense, MoE, VLM and audio
families as int8 codes with their scales, each decode step quantizing
its token's K and V (``attention._quant_kv``) and the flash kernel
reading codes and scales as they are.  The audio family's cross K/V
and the hybrid's ``ak``/``av`` stay float32, and the SSM family ignores
the option.
:func:`prefill` builds a float cache, as the reference's does: the int8
cache is reached through :func:`init_cache` and :func:`decode_step`.

The audio family's prefill takes the encoder's input, frame embeddings
``enc_frames`` (B, S_enc, D): the encoder runs once, in prefill, and
each decode step reads its K/V from ``xk``/``xv``.

The VLM family's prefill takes the stubbed vision frontend's patch
embeddings ``prefix_embeds`` (B, P, D), put before the prompt's tokens:
the cache holds the P patches' K/V and then the tokens', and ``len``
counts both, as the reference's ``S = x.shape[1]``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import (ArchConfig, AUDIO, DENSE, HYBRID,
                                      MOE, VLM)
from . import spmd
from .model import (LanguageModel, _embed, _logits, _slstm_runs,
                    dims_from_params, encode)
from .ssm import HEAD_P

Cache = Dict[str, Any]


def cache_len_for(cfg: ArchConfig, seq_len: int) -> int:
    return min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len


def init_cache(params: LanguageModel, cfg: ArchConfig, batch: int,
               max_len: Optional[int] = None,
               enc_len: Optional[int] = None,
               kv_dtype: Optional[str] = None) -> Cache:
    """An empty cache of ``batch`` sequences (see :func:`_empty_cache`);
    a model of DTensors gets a cache of DTensors, each placed by the
    sharding rules (``distributed.sharding.cache_specs``)."""
    c = _empty_cache(params, cfg, batch, max_len, enc_len, kv_dtype)
    if spmd.is_dtensor(params.embed):
        from repro_torch.distributed.sharding import cache_specs
        mesh = params.embed.device_mesh
        c = spmd.shard_like(c, cache_specs(cfg, c, mesh), mesh)
    return c


def _empty_cache(params: LanguageModel, cfg: ArchConfig, batch: int,
                 max_len: Optional[int] = None,
                 enc_len: Optional[int] = None,
                 kv_dtype: Optional[str] = None) -> Cache:
    """An empty cache of ``batch`` sequences on the model's device.  The
    K/V of the dense family and of the hybrid's shared block hold
    ``max_len`` tokens (the window under sliding-window attention); the
    audio family's cross K/V hold ``enc_len`` frames; the recurrent
    states do not grow with the sequence, and the SSM family ignores
    ``max_len``.  ``kv_dtype="int8"``: the dense, MoE, VLM and audio
    self-attention K/V as int8 with float32 scales ``ks``/``vs`` of ones,
    as the reference's; every other cache entry as without it."""
    if kv_dtype not in (None, "int8"):
        raise ValueError(f"init_cache: kv_dtype must be None or 'int8', "
                         f"got {kv_dtype!r}")
    dims = dims_from_params(params, cfg)
    dev, dtype = params.embed.device, params.embed.dtype
    L, D = cfg.n_layers, cfg.d_model

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    c = {"len": zeros(dtype=torch.int32)}
    if cfg.family in (DENSE, MOE, VLM, AUDIO, HYBRID):
        if max_len is None:
            raise ValueError(f"init_cache: the {cfg.family!r} family needs "
                             f"max_len")
        S = cache_len_for(cfg, max_len)
    if cfg.family == AUDIO:
        if enc_len is None:
            raise ValueError(f"init_cache: the {cfg.family!r} family needs "
                             f"enc_len")
        c["xk"] = zeros(L, batch, enc_len, dims.K, dims.hd, dtype=dtype)
        c["xv"] = zeros(L, batch, enc_len, dims.K, dims.hd, dtype=dtype)
    if cfg.family in (DENSE, MOE, VLM, AUDIO):
        kvd = torch.int8 if kv_dtype == "int8" else dtype
        c["k"] = zeros(L, batch, S, dims.K, dims.hd, dtype=kvd)
        c["v"] = zeros(L, batch, S, dims.K, dims.hd, dtype=kvd)
        if kv_dtype == "int8":
            c["ks"] = torch.ones((L, batch, S, dims.K, 1),
                                 dtype=torch.float32, device=dev)
            c["vs"] = torch.ones_like(c["ks"])
        return c
    if cfg.family == HYBRID:
        d_in = cfg.ssm_expand * D
        n_app = L // cfg.shared_attn_every
        c["conv"] = zeros(L, batch, cfg.ssm_conv - 1,
                          d_in + 2 * cfg.ssm_state, dtype=dtype)
        c["ssm"] = zeros(L, batch, d_in // HEAD_P, cfg.ssm_state, HEAD_P)
        c["ak"] = zeros(n_app, batch, S, dims.K, dims.hd, dtype=dtype)
        c["av"] = zeros(n_app, batch, S, dims.K, dims.hd, dtype=dtype)
        return c
    nh = cfg.n_heads
    hd2 = 2 * D // nh
    Lm = L - len(cfg.slstm_layers)
    Ls = len(cfg.slstm_layers)
    return {
        **c,
        "m_num": zeros(Lm, batch * nh, 1, hd2, hd2),
        "m_den": zeros(Lm, batch * nh, 1, hd2, 1),
        "s_h": zeros(Ls, batch, D),
        "s_c": zeros(Ls, batch, D),
        "s_n": torch.ones((Ls, batch, D), dtype=torch.float32, device=dev),
    }


def _run_stack(params: LanguageModel, cfg: ArchConfig, x: torch.Tensor,
               cache: Cache) -> Tuple[torch.Tensor, Cache]:
    """The layers in order, each from and into its cache state."""
    new = dict(cache)
    m_num, m_den = [], []
    s_state = {k: list(cache[k].unbind(0)) for k in ("s_h", "s_c", "s_n")}
    mi = 0
    for run_len, s_idx in _slstm_runs(cfg):
        for _ in range(run_len):
            x, st = params.mlstm_layers[mi](
                x, state={"num": cache["m_num"][mi],
                          "den": cache["m_den"][mi]})
            m_num.append(st["num"])
            m_den.append(st["den"])
            mi += 1
        if s_idx is not None:
            x, st = params.slstm_layers[s_idx](
                x, state={g: cache[f"s_{g}"][s_idx] for g in "hcn"})
            for g in "hcn":
                s_state[f"s_{g}"][s_idx] = st[g]
    if m_num:
        new["m_num"], new["m_den"] = torch.stack(m_num), torch.stack(m_den)
    for k, v in s_state.items():
        if v:
            new[k] = torch.stack(v)
    return x, new


def _store(dst: torch.Tensor, t: torch.Tensor) -> None:
    """A prefill's K or V (B, S, K, hd) into one layer's cache (B,
    S_cache, K, hd): padded to its length, or, under a sliding window
    shorter than the prompt, the last S_cache entries at slots ``pos %
    S_cache``."""
    S, S_cache = t.shape[1], dst.shape[1]
    if S <= S_cache:
        dst[:, :S] = t
    else:       # torch.roll by r as two slices: DTensor (torch 2.11)
        # has no roll strategy, and the two give the same values
        last, r = t[:, -S_cache:], S % S_cache
        dst.copy_(torch.cat([last[:, S_cache - r:], last[:, :S_cache - r]],
                            dim=1))


def _dense_prefill(params: LanguageModel, x: torch.Tensor, cache: Cache,
                   dispatch: str, enc_out: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """The layers in order (MoE at the config's capacity factor); each
    layer's K/V go into the cache, and with ``enc_out`` (the audio
    family) its cross-attention K/V into ``xk``/``xv``."""
    for i, layer in enumerate(params.layers):
        x, kv = layer(x, enc_out=enc_out, dispatch=dispatch)
        _store(cache["k"][i], kv["k"])
        _store(cache["v"][i], kv["v"])
        if enc_out is not None:
            cache["xk"][i] = kv["xk"]
            cache["xv"][i] = kv["xv"]
    return x


def _hybrid_stack(params: LanguageModel, cfg: ArchConfig, x: torch.Tensor,
                  cache: Cache, decode: bool) -> torch.Tensor:
    """The Mamba2 layers in order, each from and into its cache state,
    and the shared block after every ``shared_attn_every`` of them: after
    each full group only, so the tail of ``n_layers % shared_attn_every``
    layers has none.  Prefill stores the block's K/V at each application
    into ``ak``/``av``; decode writes the token's slot there, in place."""
    k = cfg.shared_attn_every
    for i, layer in enumerate(params.layers):
        x, st = layer(x, state={"conv": cache["conv"][i],
                                "ssm": cache["ssm"][i]})
        cache["conv"][i] = st["conv"]
        cache["ssm"][i] = st["ssm"]
        if (i + 1) % k:
            continue
        g = (i + 1) // k - 1
        if decode:
            x, _ = params.shared_attn(x, state={
                "k": cache["ak"][g], "v": cache["av"][g],
                "len": cache["len"]})
        else:
            x, kv = params.shared_attn(x)
            _store(cache["ak"][g], kv["k"])
            _store(cache["av"][g], kv["v"])
    return x


@torch.no_grad()
def decode_step(params: LanguageModel, cfg: ArchConfig, cache: Cache,
                tokens: torch.Tensor, *, dispatch: str = "einsum"
                ) -> Tuple[torch.Tensor, Cache]:
    """tokens (B, 1) int.  Returns (logits (B, V), new cache); the dense,
    MoE, VLM, audio and hybrid caches are updated in place, an int8 cache's
    scales ``ks``/``vs`` with its codes."""
    x = _embed(params, cfg, tokens)
    new = dict(cache)
    if cfg.family in (DENSE, MOE, VLM, AUDIO):
        cf = max(cfg.capacity_factor, 2.0)
        keys = ("k", "v", *(("xk", "xv") if cfg.family == AUDIO else ()),
                *(("ks", "vs") if "ks" in cache else ()))
        for i, layer in enumerate(params.layers):
            state = {k: cache[k][i] for k in keys}
            x, _ = layer(x, state=dict(state, len=cache["len"]),
                         dispatch=dispatch, capacity_factor=cf)
    elif cfg.family == HYBRID:
        x = _hybrid_stack(params, cfg, x, cache, decode=True)
    else:
        x, new = _run_stack(params, cfg, x, cache)
    new["len"] = cache["len"] + 1
    return _logits(params, cfg, x)[:, -1], new


@torch.no_grad()
def prefill(params: LanguageModel, cfg: ArchConfig, tokens: torch.Tensor, *,
            max_len: Optional[int] = None, dispatch: str = "einsum",
            enc_frames: Optional[torch.Tensor] = None,
            prefix_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Cache]:
    """Full-sequence forward that also builds the decode cache.  Returns
    (logits (B, S, V), cache), S the embedded sequence: ``prefix_embeds``
    (B, P, D), where given, then the S_tok tokens, S = P + S_tok, as the
    reference's ``_embed`` builds it for any family (the VLM family's
    patch embeddings).  The dense, MoE, VLM, audio and hybrid K/V caches
    hold ``max_len`` positions (default: S) and ``len`` is S; the SSM
    family ignores ``max_len``.  The audio family needs ``enc_frames``
    (B, S_enc, D), which it encodes first; no other family takes them.
    The scans of Mamba2 and mLSTM take chunks of ``min(128, S)``
    positions, as in the reference, which must divide S."""
    if (enc_frames is None) == (cfg.family == AUDIO):
        raise ValueError(f"prefill: the {cfg.family!r} family "
                         + ("needs" if cfg.family == AUDIO else
                            "takes no") + " enc_frames")
    x = _embed(params, cfg, tokens, prefix_embeds)
    B, S = x.shape[:2]
    cache = init_cache(params, cfg, B, max_len or S,
                       enc_len=None if enc_frames is None
                       else enc_frames.shape[1])
    if cfg.family in (DENSE, MOE, VLM, AUDIO):
        x = _dense_prefill(params, x, cache, dispatch,
                           enc_out=None if enc_frames is None
                           else encode(params, cfg, enc_frames))
    elif cfg.family == HYBRID:
        x = _hybrid_stack(params, cfg, x, cache, decode=False)
    else:
        x, cache = _run_stack(params, cfg, x, cache)
    cache["len"] = torch.tensor(S, dtype=torch.int32, device=x.device)
    return _logits(params, cfg, x), cache

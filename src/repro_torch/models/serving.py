"""Serving entry points: cache construction, prefill, single-token
decode — the counterparts of ``repro/models/serving.py`` for the dense
and SSM families.

Cache keys and shapes are the reference's (B = batch, L = layers):

  dense:  k, v (L, B, S, K, hd)           float32; S = max_len, or the
                                          sliding window (a ring buffer)
  SSM:    m_num (Lm, B*nh, 1, hd2, hd2)   mLSTM numerator states (float32)
          m_den (Lm, B*nh, 1, hd2, 1)     mLSTM denominator states
          s_h, s_c, s_n (Ls, B, D)        sLSTM states
          (nh = heads, hd2 = 2 * d_model / nh, Lm / Ls = mLSTM / sLSTM
          layers)
  both:   len ()                          tokens seen (int32, on the
                                          model's device)

:func:`prefill` returns a new cache.  :func:`decode_step` returns a new
cache dict; the SSM states in it are new tensors and the one it was
given stays as it was, but the dense K/V caches are written **in
place** (one slot a step of caches that are gigabytes at full width),
so the returned dict shares them with the given one.  The valid length
stays on the device: a decode step reads it without a host sync.  Both
run without autograd.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, DENSE
from .model import (LanguageModel, _embed, _logits, _slstm_runs,
                    dims_from_params)

Cache = Dict[str, Any]


def cache_len_for(cfg: ArchConfig, seq_len: int) -> int:
    return min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len


def init_cache(params: LanguageModel, cfg: ArchConfig, batch: int,
               max_len: Optional[int] = None) -> Cache:
    """An empty cache of ``batch`` sequences on the model's device.  The
    dense family's K/V hold ``max_len`` tokens (the window under
    sliding-window attention); the SSM state does not grow with the
    sequence, and the family ignores ``max_len``."""
    dims = dims_from_params(params, cfg)   # raises for unported families
    dev = params.embed.device
    if cfg.family == DENSE:
        if max_len is None:
            raise ValueError("init_cache: the dense family needs max_len")
        shape = (cfg.n_layers, batch, cache_len_for(cfg, max_len), dims.K,
                 dims.hd)
        return {"len": torch.zeros((), dtype=torch.int32, device=dev),
                "k": torch.zeros(shape, dtype=params.embed.dtype,
                                 device=dev),
                "v": torch.zeros(shape, dtype=params.embed.dtype,
                                 device=dev)}
    D, nh = cfg.d_model, cfg.n_heads
    hd2 = 2 * D // nh
    Lm = cfg.n_layers - len(cfg.slstm_layers)
    Ls = len(cfg.slstm_layers)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    return {
        "len": torch.zeros((), dtype=torch.int32, device=dev),
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


def _dense_prefill(params: LanguageModel, x: torch.Tensor,
                   cache: Cache) -> torch.Tensor:
    """The layers in order; each layer's K/V go into the cache: padded to
    its length, or, under a sliding window shorter than the prompt, the
    last S_cache entries at slots ``pos % S_cache``."""
    S = x.shape[1]
    S_cache = cache["k"].shape[2]
    for i, layer in enumerate(params.layers):
        x, kv = layer(x)
        for name, t in kv.items():
            if S <= S_cache:
                cache[name][i, :, :S] = t
            else:
                cache[name][i] = torch.roll(t[:, -S_cache:], S % S_cache,
                                            dims=1)
    return x


@torch.no_grad()
def decode_step(params: LanguageModel, cfg: ArchConfig, cache: Cache,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """tokens (B, 1) int.  Returns (logits (B, V), new cache); the dense
    K/V caches are updated in place."""
    x = _embed(params, cfg, tokens)
    if cfg.family == DENSE:
        new = dict(cache)
        for i, layer in enumerate(params.layers):
            x, _ = layer(x, state={"k": cache["k"][i], "v": cache["v"][i],
                                   "len": cache["len"]})
    else:
        x, new = _run_stack(params, cfg, x, cache)
    new["len"] = cache["len"] + 1
    return _logits(params, cfg, x)[:, -1], new


@torch.no_grad()
def prefill(params: LanguageModel, cfg: ArchConfig, tokens: torch.Tensor, *,
            max_len: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
    """Full-sequence forward that also builds the decode cache.  Returns
    (logits (B, S, V), cache).  The dense cache holds ``max_len`` tokens
    (default: the prompt's); the SSM family ignores ``max_len``, and its
    mLSTM scans take chunks of 128 tokens, as in the reference."""
    B, S = tokens.shape
    x = _embed(params, cfg, tokens)
    cache = init_cache(params, cfg, B, max_len or S)
    if cfg.family == DENSE:
        x = _dense_prefill(params, x, cache)
    else:
        x, cache = _run_stack(params, cfg, x, cache)
    cache["len"] = torch.tensor(S, dtype=torch.int32, device=x.device)
    return _logits(params, cfg, x), cache

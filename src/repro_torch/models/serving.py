"""Serving entry points: cache construction, prefill, single-token
decode — the counterparts of ``repro/models/serving.py`` for the SSM
family.

The SSM cache is constant-size, with the reference's keys and shapes
(B = batch, nh = heads, hd2 = 2 * d_model / nh, Lm / Ls = mLSTM / sLSTM
layers):

  m_num (Lm, B*nh, 1, hd2, hd2)   mLSTM numerator states (float32)
  m_den (Lm, B*nh, 1, hd2, 1)     mLSTM denominator states
  s_h, s_c, s_n (Ls, B, D)        sLSTM states
  len ()                          tokens seen (int32)

Like the reference, :func:`prefill` and :func:`decode_step` return a new
cache and leave the one they were given as it was.  Both run without
autograd.  The reference's ``max_len`` and attention ``chunk`` have no
counterpart here: the SSM state does not grow with the sequence, and
the family has no attention.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from .model import (LanguageModel, _embed, _logits, _slstm_runs,
                    dims_from_params)

Cache = Dict[str, Any]


def init_cache(params: LanguageModel, cfg: ArchConfig, batch: int
               ) -> Cache:
    """An empty cache of ``batch`` sequences on the model's device."""
    dims_from_params(params, cfg)          # raises for unported families
    dev = params.embed.device
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


@torch.no_grad()
def decode_step(params: LanguageModel, cfg: ArchConfig, cache: Cache,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """tokens (B, 1) int.  Returns (logits (B, V), new cache)."""
    x = _embed(params, cfg, tokens)
    x, new = _run_stack(params, cfg, x, cache)
    new["len"] = cache["len"] + 1
    return _logits(params, cfg, x)[:, -1], new


@torch.no_grad()
def prefill(params: LanguageModel, cfg: ArchConfig, tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, Cache]:
    """Full-sequence forward that also builds the decode cache.  Returns
    (logits (B, S, V), cache).  The mLSTM scans take chunks of 128
    tokens, as in the reference."""
    B, S = tokens.shape
    x = _embed(params, cfg, tokens)
    cache = init_cache(params, cfg, B)
    x, cache = _run_stack(params, cfg, x, cache)
    cache["len"] = torch.tensor(S, dtype=torch.int32, device=x.device)
    return _logits(params, cfg, x), cache

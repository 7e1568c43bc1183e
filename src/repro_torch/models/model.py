"""Model assembly, the counterpart of ``repro/models/model.py``.

:func:`init_params` builds a :class:`LanguageModel`, an ``nn.Module``
whose ``state_dict`` keys follow the reference's parameter tree
(``embed``, ``final_norm``, ``lm_head``, ``mlstm_layers.<i>.mlstm.wq``,
...; :mod:`.convert` maps one onto the other).  Only the SSM family
(xLSTM: a stack of mLSTM layers with sLSTM layers at their configured
indices) is ported; every other family raises ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, SSM
from .layers import apply_norm, dense_init
from .ssm import MLSTMBlock, SLSTMBlock


@dataclass(frozen=True)
class ModelDims:
    H: int
    K: int
    hd: int


def require_ported(cfg: ArchConfig) -> None:
    if cfg.family != SSM:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported to "
            f"PyTorch yet (ROADMAP.md, queue 1 item 6: the dense serving "
            f"slice comes next, the hybrid one after it); only the "
            f"{SSM!r} family (xlstm-125m) is")


def padded_vocab(cfg: ArchConfig) -> int:
    """Vocab padded to a multiple of 256, as in the reference."""
    return -(-cfg.vocab_size // 256) * 256


class LanguageModel(nn.Module):
    """Token embedding, the layer stack, final norm and LM head."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        require_ported(cfg)
        self.cfg = cfg
        D, V = cfg.d_model, padded_vocab(cfg)
        self.embed = nn.Parameter(dense_init(gen, (V, D), dtype, scale=1.0))
        self.final_norm = nn.Parameter(torch.ones(D, dtype=dtype))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(dense_init(gen, (D, V), dtype))
        n_m = cfg.n_layers - len(cfg.slstm_layers)
        self.mlstm_layers = nn.ModuleList(
            MLSTMBlock(cfg, gen, dtype) for _ in range(n_m))
        self.slstm_layers = nn.ModuleList(
            SLSTMBlock(cfg, gen, dtype) for _ in cfg.slstm_layers)


def init_params(cfg: ArchConfig, seed: int = 0,
                dtype: torch.dtype = torch.float32,
                device: Optional[Union[str, torch.device]] = None
                ) -> LanguageModel:
    """A model with random weights drawn on the CPU from ``seed``, so
    every device gets the same numbers; then moved to ``device``."""
    model = LanguageModel(cfg, torch.Generator().manual_seed(seed), dtype)
    return model.to(device) if device is not None else model


def _slstm_runs(cfg: ArchConfig) -> List[Tuple[int, Optional[int]]]:
    """[(mlstm_run_length, slstm_list_index_or_None), ...] covering L."""
    runs = []
    run = 0
    s_seen = 0
    for i in range(cfg.n_layers):
        if i in cfg.slstm_layers:
            runs.append((run, s_seen))
            s_seen += 1
            run = 0
        else:
            run += 1
    runs.append((run, None))
    return runs


def _embed(params: LanguageModel, cfg: ArchConfig,
           tokens: torch.Tensor) -> torch.Tensor:
    return params.embed[tokens]


def _logits(params: LanguageModel, cfg: ArchConfig,
            x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(cfg.norm, x, params.final_norm)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return x @ head


def dims_from_params(params: LanguageModel, cfg: ArchConfig) -> ModelDims:
    """Head counts as initialized.  The SSM family has no attention and
    no head padding, so they are the config's."""
    require_ported(cfg)
    return ModelDims(cfg.n_heads, cfg.n_kv_heads, cfg.hd)

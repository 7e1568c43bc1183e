"""Model assembly, the counterpart of ``repro/models/model.py``.

:func:`init_params` builds a :class:`LanguageModel`, an ``nn.Module``
whose ``state_dict`` keys follow the reference's parameter tree
(``embed``, ``final_norm``, ``lm_head``, ``layers.<i>.attn.wq``,
``mlstm_layers.<i>.mlstm.wq``, ...; :mod:`.convert` maps one onto the
other).  Four families are ported: the dense decoder (a stack of
:class:`DenseBlock`, stablelm-3b), the MoE family (the same stack with
a :class:`~.moe.MoELayer` in place of each MLP, mixtral-8x7b and
arctic-480b), the hybrid (zamba2-1.2b: a stack of
:class:`~.ssm.Mamba2Block` and one shared-weight :class:`DenseBlock`
applied after every ``shared_attn_every`` of them) and the SSM family
(xLSTM: a stack of mLSTM layers with sLSTM layers at their configured
indices); every other family raises ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import (ArchConfig, AUDIO, DENSE, HYBRID, MOE,
                                      SSM, VLM)
from .attention import attn_apply, attn_init, decode_attention
from .layers import apply_norm, dense_init, mlp_apply, mlp_init
from .moe import MoELayer
from .ssm import Mamba2Block, MLSTMBlock, SLSTMBlock


@dataclass(frozen=True)
class ModelDims:
    H: int
    K: int
    hd: int


# the ROADMAP.md item (queue 1 item 6) each unported family waits for
NOT_PORTED = {VLM: "the audio and VLM families",
              AUDIO: "the audio and VLM families"}


def require_ported(cfg: ArchConfig) -> None:
    if cfg.family not in (DENSE, MOE, HYBRID, SSM):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported to "
            f"PyTorch yet (ROADMAP.md, queue 1 item 6: "
            f"{NOT_PORTED.get(cfg.family, 'not planned')}); only the "
            f"{DENSE!r} (stablelm-3b), {MOE!r} (mixtral-8x7b, "
            f"arctic-480b), {HYBRID!r} (zamba2-1.2b) and {SSM!r} "
            f"(xlstm-125m) families are")


def model_dims(cfg: ArchConfig) -> ModelDims:
    """Head counts padded for tensor parallelism at the port's one
    degree, tp = 1, where they are the config's."""
    H, K = cfg.padded_heads(1)
    return ModelDims(H, K, cfg.hd)


def padded_vocab(cfg: ArchConfig) -> int:
    """Vocab padded to a multiple of 256, as in the reference."""
    return -(-cfg.vocab_size // 256) * 256


class DenseBlock(nn.Module):
    """One pre-norm decoder layer of the dense family: ``x + attn(ln1
    x)``, then ``x + MLP(ln2 x)``; in the MoE family ``x + MoE(ln2 x)``.
    The parameters keep the reference's names (``ln1``, ``attn``,
    ``ln2``, and ``mlp`` or ``moe``)."""

    def __init__(self, cfg: ArchConfig, dims: ModelDims,
                 gen: torch.Generator, dtype: torch.dtype = torch.float32):
        super().__init__()
        D = cfg.d_model
        self.cfg, self.dims = cfg, dims
        self.ln1 = nn.Parameter(torch.ones(D, dtype=dtype))
        self.attn = nn.ParameterDict(attn_init(gen, D, dims.H, dims.K,
                                               dims.hd, dtype))
        self.ln2 = nn.Parameter(torch.ones(D, dtype=dtype))
        if cfg.family == MOE:
            self.moe = MoELayer(gen, D, cfg.d_ff, cfg.n_experts,
                                cfg.activation, dtype,
                                dense_ff=(cfg.dense_ff
                                          if cfg.moe_dense_residual else 0))
        else:
            self.mlp = nn.ParameterDict(mlp_init(gen, D, cfg.d_ff,
                                                 cfg.activation, dtype))

    def forward(self, x: torch.Tensor, state: Optional[dict] = None, *,
                dispatch: str = "einsum",
                capacity_factor: Optional[float] = None
                ) -> Tuple[torch.Tensor, dict]:
        """Prefill (``state`` None): x (B, S, D) -> (x, {"k", "v"}), the
        layer's post-RoPE K and V (B, S, K, hd).  Decode: x (B, 1, D) with
        ``state`` {"k", "v"} (B, S_max, K, hd) caches and "len", the
        valid entries before this token -> (x, {"k", "v"}), the same
        cache tensors, written in place.

        The MoE family routes each prefill sequence as one group, (B, S,
        D), and a decode step's whole batch as one, (1, B, D), as the
        reference's prefill and ``_ffn_or_moe``, through ``dispatch``
        ("einsum" or "sort") at ``capacity_factor`` (default the
        config's); the caller sets the factor for each phase."""
        cfg, dims = self.cfg, self.dims
        hn = apply_norm(cfg.norm, x, self.ln1)
        kw = dict(n_heads=dims.H, n_kv=dims.K, hd=dims.hd,
                  rope_theta=cfg.rope_theta, window=cfg.sliding_window)
        if state is None:
            y, k, v = attn_apply(dict(self.attn), hn, causal=True, **kw)
        else:
            y, k, v = decode_attention(dict(self.attn), hn, state["k"],
                                       state["v"], state["len"], **kw)
        x = x + y
        hn = apply_norm(cfg.norm, x, self.ln2)
        if cfg.family != MOE:
            return x + mlp_apply(dict(self.mlp), hn, cfg.activation), {
                "k": k, "v": v}
        groups = hn if state is None else hn.reshape(1, -1, cfg.d_model)
        y, _ = self.moe(groups, top_k=cfg.top_k, activation=cfg.activation,
                        capacity_factor=(cfg.capacity_factor
                                         if capacity_factor is None
                                         else capacity_factor),
                        dispatch=dispatch)
        return x + y.reshape(hn.shape), {"k": k, "v": v}


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
        if cfg.family in (DENSE, MOE):
            dims = model_dims(cfg)
            self.layers = nn.ModuleList(
                DenseBlock(cfg, dims, gen, dtype)
                for _ in range(cfg.n_layers))
            return
        if cfg.family == HYBRID:
            self.layers = nn.ModuleList(
                Mamba2Block(cfg, gen, dtype) for _ in range(cfg.n_layers))
            self.shared_attn = DenseBlock(cfg, model_dims(cfg), gen, dtype)
            return
        n_m = cfg.n_layers - len(cfg.slstm_layers)
        self.mlstm_layers = nn.ModuleList(
            MLSTMBlock(cfg, gen, dtype) for _ in range(n_m))
        self.slstm_layers = nn.ModuleList(
            SLSTMBlock(cfg, gen, dtype) for _ in cfg.slstm_layers)


def init_params(cfg: ArchConfig, seed: int = 0,
                dtype: torch.dtype = torch.float32,
                device: Optional[Union[str, torch.device]] = None
                ) -> LanguageModel:
    """A model with random weights drawn from ``seed`` on ``device`` (the
    CPU if None).  Two devices draw different numbers from one seed: to
    compare them, hand one model's ``state_dict`` to the other."""
    gen = torch.Generator(device=device or "cpu").manual_seed(seed)
    with torch.device(gen.device):      # the constant parameters too
        return LanguageModel(cfg, gen, dtype)


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
    """Head counts as initialized, from the ``wq``/``wk`` widths of the
    dense and MoE families' layers or the hybrid's shared block (head padding
    included).  The SSM family has no attention and no head padding, so
    they are the config's."""
    require_ported(cfg)
    if cfg.family == SSM:
        return ModelDims(cfg.n_heads, cfg.n_kv_heads, cfg.hd)
    attn = (params.shared_attn.attn if cfg.family == HYBRID
            else params.layers[0].attn)
    hd = cfg.hd
    return ModelDims(attn["wq"].shape[-1] // hd, attn["wk"].shape[-1] // hd,
                     hd)

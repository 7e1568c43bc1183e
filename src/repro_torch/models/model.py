"""Model assembly, the counterpart of ``repro/models/model.py``.

:func:`init_params` builds a :class:`LanguageModel`, an ``nn.Module``
whose ``state_dict`` keys follow the reference's parameter tree
(``embed``, ``final_norm``, ``lm_head``, ``layers.<i>.attn.wq``,
``mlstm_layers.<i>.mlstm.wq``, ...; :mod:`.convert` maps one onto the
other).  Five families are ported: the dense decoder (a stack of
:class:`DenseBlock`: stablelm-3b, deepseek-coder-33b, granite-20b,
phi3-medium-14b), the MoE family (the same stack with
a :class:`~.moe.MoELayer` in place of each MLP, mixtral-8x7b and
arctic-480b), the audio family (seamless-m4t-large-v2: an encoder stack
of non-causal :class:`DenseBlock` over frame embeddings, :func:`encode`,
and a decoder stack of :class:`DenseBlock` with cross-attention), the
hybrid (zamba2-1.2b: a stack of :class:`~.ssm.Mamba2Block` and one
shared-weight :class:`DenseBlock` applied after every
``shared_attn_every`` of them), the SSM family (xLSTM: a stack of
mLSTM layers with sLSTM layers at their configured indices) and the VLM
family (internvl2-76b: the dense stack, its input the stubbed vision
frontend's patch embeddings, ``prefix_embeds`` (B, P, D), put before the
looked-up tokens by :func:`_embed`).  Every attention layer is built
at the head counts of :func:`model_dims`, padded for a tensor-parallel
degree as the reference pads them (``init_params(..., tp=, pad_kv=)``).

:func:`forward_train` is the training loss of the dense, MoE and VLM
families, differentiable through autograd (attention's gradient is
``kernels.flash_attention.FlashAttention``'s).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ArchConfig, AUDIO, DENSE, HYBRID, MOE,
                                      SSM, VLM)
from . import spmd
from .attention import (attn_apply, attn_init, cross_attention,
                        decode_attention)
from .layers import (apply_norm, cross_entropy_loss, dense_init, mlp_apply,
                     mlp_init)
from .moe import MoELayer
from .ssm import Mamba2Block, MLSTMBlock, SLSTMBlock


@dataclass(frozen=True)
class ModelDims:
    H: int
    K: int
    hd: int


def model_dims(cfg: ArchConfig, tp: int = 1, pad_kv: bool = False
               ) -> ModelDims:
    """Head counts padded up to divide the tensor-parallel degree ``tp``
    (``ArchConfig.padded_heads``); ``pad_kv`` pads the KV heads to a
    multiple of ``tp`` as well, MQA's one head excepted.  The padded
    heads are drawn like the others, as in the reference.  A padding
    can leave a query group uneven (phi3-medium-14b at tp 8: 40 query
    heads over 16 KV heads): such a model builds, and its attention
    raises."""
    H, K = cfg.padded_heads(tp, pad_kv)
    return ModelDims(H, K, cfg.hd)


def padded_vocab(cfg: ArchConfig) -> int:
    """Vocab padded to a multiple of 256, as in the reference."""
    return -(-cfg.vocab_size // 256) * 256


class CrossAttention(nn.Module):
    """The audio decoder's cross-attention sub-layer, a module of its
    own so that hooks see it; its weights are ``wq``, ``wk``, ``wv`` and
    ``wo``, as the reference's ``xattn``.  Prefill projects K/V from the
    encoder's output, decode reads the ones prefill stored."""

    def __init__(self, weights: Dict[str, torch.Tensor]):
        super().__init__()
        for name, t in weights.items():
            self.register_parameter(name, nn.Parameter(t))

    def forward(self, x: torch.Tensor, dims: ModelDims, *,
                enc_out: Optional[torch.Tensor] = None,
                kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x (B, S, D), normed.  Returns (out, k, v), k and v (B, S_enc,
        K, hd)."""
        p = dict(self.named_parameters())
        if kv is None:   # no RoPE on either side: rope_theta is unread
            return attn_apply(p, x, n_heads=dims.H, n_kv=dims.K,
                              hd=dims.hd, rope_theta=0.0, kv_x=enc_out)
        return cross_attention(p, x, *kv, n_heads=dims.H, hd=dims.hd), *kv


class DenseBlock(nn.Module):
    """One pre-norm layer of the dense family: ``x + attn(ln1 x)``, then
    ``x + MLP(ln2 x)``; in the MoE family ``x + MoE(ln2 x)``.  With
    ``cross`` (the audio decoder) ``x + xattn(lnx x)`` over the
    encoder's output comes between the two.  The parameters keep the
    reference's names (``ln1``, ``attn``, ``ln2``, ``lnx``, ``xattn``,
    and ``mlp`` or ``moe``)."""

    def __init__(self, cfg: ArchConfig, dims: ModelDims,
                 gen: torch.Generator, dtype: torch.dtype = torch.float32,
                 cross: bool = False):
        super().__init__()
        D = cfg.d_model
        self.cfg, self.dims = cfg, dims
        self.ln1 = nn.Parameter(torch.ones(D, dtype=dtype))
        self.attn = nn.ParameterDict(attn_init(gen, D, dims.H, dims.K,
                                               dims.hd, dtype))
        self.ln2 = nn.Parameter(torch.ones(D, dtype=dtype))
        if cross:
            self.lnx = nn.Parameter(torch.ones(D, dtype=dtype))
            self.xattn = CrossAttention(attn_init(gen, D, dims.H, dims.K,
                                                  dims.hd, dtype))
        if cfg.family == MOE:
            self.moe = MoELayer(gen, D, cfg.d_ff, cfg.n_experts,
                                cfg.activation, dtype,
                                dense_ff=(cfg.dense_ff
                                          if cfg.moe_dense_residual else 0))
        else:
            self.mlp = nn.ParameterDict(mlp_init(gen, D, cfg.d_ff,
                                                 cfg.activation, dtype))

    def forward(self, x: torch.Tensor, state: Optional[dict] = None, *,
                enc_out: Optional[torch.Tensor] = None, causal: bool = True,
                dispatch: str = "einsum",
                capacity_factor: Optional[float] = None
                ) -> Tuple[torch.Tensor, dict]:
        """Prefill (``state`` None): x (B, S, D) -> (x, {"k", "v"}), the
        layer's post-RoPE K and V (B, S, K, hd); ``causal`` False for the
        audio encoder.  Decode: x (B, 1, D) with ``state`` {"k", "v"}
        (B, S_max, K, hd) caches and "len", the valid entries before
        this token -> (x, {"k", "v"}), the same cache tensors, written in
        place; an int8 cache's state also holds its scales "ks", "vs"
        (B, S_max, K, 1), returned and written in place beside it.  Both
        dicts also hold "aux", the MoE layer's
        load-balancing loss (0.0 in the dense family).  A layer with
        cross-attention takes ``enc_out`` (B, S_enc, D) in prefill and
        returns its K/V as "xk", "xv" (B, S_enc, K, hd); in decode it
        reads them from ``state``.

        The MoE family routes each prefill sequence as one group, (B, S,
        D), and a decode step's whole batch as one, (1, B, D), as the
        reference's prefill and ``_ffn_or_moe``, through ``dispatch``
        ("einsum" or "sort") at ``capacity_factor`` (default the
        config's); the caller sets the factor for each phase."""
        cfg, dims = self.cfg, self.dims
        hn = apply_norm(cfg.norm, x, self.ln1)
        kw = dict(n_heads=dims.H, n_kv=dims.K, hd=dims.hd,
                  rope_theta=cfg.rope_theta, window=cfg.sliding_window)
        out = {"aux": 0.0}
        if state is None:
            y, out["k"], out["v"] = attn_apply(dict(self.attn), hn,
                                               causal=causal, **kw)
        elif "ks" in state:     # the int8 cache, its scales beside it
            y, out["k"], out["v"], (out["ks"], out["vs"]) = decode_attention(
                dict(self.attn), hn, state["k"], state["v"], state["len"],
                kv_scales=(state["ks"], state["vs"]), **kw)
        else:
            y, out["k"], out["v"] = decode_attention(
                dict(self.attn), hn, state["k"], state["v"], state["len"],
                **kw)
        x = x + y
        if hasattr(self, "xattn"):
            if (enc_out is None) == (state is None):
                raise ValueError("a cross-attention layer takes enc_out in "
                                 "prefill and the stored xk/xv in decode")
            y, out["xk"], out["xv"] = self.xattn(
                apply_norm(cfg.norm, x, self.lnx), dims, enc_out=enc_out,
                kv=None if state is None else (state["xk"], state["xv"]))
            x = x + y
        hn = apply_norm(cfg.norm, x, self.ln2)
        if cfg.family != MOE:
            return x + mlp_apply(dict(self.mlp), hn, cfg.activation), out
        groups = hn if state is None else hn.reshape(1, -1, cfg.d_model)
        y, aux = self.moe(groups, top_k=cfg.top_k,
                          activation=cfg.activation,
                          capacity_factor=(cfg.capacity_factor
                                           if capacity_factor is None
                                           else capacity_factor),
                          dispatch=dispatch)
        return x + y.reshape(hn.shape), dict(out, aux=aux)


class LanguageModel(nn.Module):
    """Token embedding, the layer stack, final norm and LM head; the
    attention layers (dense, MoE, VLM and audio stacks, the hybrid's
    shared block) at the head counts ``dims`` (default
    ``model_dims(cfg)``)."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator,
                 dtype: torch.dtype = torch.float32,
                 dims: Optional[ModelDims] = None):
        super().__init__()
        dims = dims or model_dims(cfg)
        self.cfg = cfg
        D, V = cfg.d_model, padded_vocab(cfg)
        self.embed = nn.Parameter(dense_init(gen, (V, D), dtype, scale=1.0))
        self.final_norm = nn.Parameter(torch.ones(D, dtype=dtype))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(dense_init(gen, (D, V), dtype))
        if cfg.family in (DENSE, MOE, VLM, AUDIO):
            if cfg.family == AUDIO:
                self.enc_layers = nn.ModuleList(
                    DenseBlock(cfg, dims, gen, dtype)
                    for _ in range(cfg.encoder_layers))
            self.layers = nn.ModuleList(
                DenseBlock(cfg, dims, gen, dtype, cross=cfg.family == AUDIO)
                for _ in range(cfg.n_layers))
            return
        if cfg.family == HYBRID:
            self.layers = nn.ModuleList(
                Mamba2Block(cfg, gen, dtype) for _ in range(cfg.n_layers))
            self.shared_attn = DenseBlock(cfg, dims, gen, dtype)
            return
        n_m = cfg.n_layers - len(cfg.slstm_layers)
        self.mlstm_layers = nn.ModuleList(
            MLSTMBlock(cfg, gen, dtype) for _ in range(n_m))
        self.slstm_layers = nn.ModuleList(
            SLSTMBlock(cfg, gen, dtype) for _ in cfg.slstm_layers)


def init_params(cfg: ArchConfig, seed: int = 0,
                dtype: torch.dtype = torch.float32,
                device: Optional[Union[str, torch.device]] = None, *,
                tp: int = 1, pad_kv: bool = False) -> LanguageModel:
    """A model with random weights drawn from ``seed`` on ``device`` (the
    CPU if None), its attention at ``model_dims(cfg, tp, pad_kv)`` (the
    SSM family has none and ignores both).  Two devices draw different
    numbers from one seed: to compare them, hand one model's
    ``state_dict`` to the other.  On the meta device the model is shape
    only, as ``jax.eval_shape`` gives the reference's: no generator is
    made, nothing is drawn and no byte is allocated."""
    dev = torch.device(device or "cpu")
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    with torch.device(dev):             # the constant parameters too
        return LanguageModel(cfg, gen, dtype, model_dims(cfg, tp, pad_kv))


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


class _Lookup(torch.autograd.Function):
    """``table[tokens]`` with a backward that gives the same bits on
    every run.  Indexing's own backward adds the rows of a repeated token
    with atomics on CUDA, in an order that changes from run to run, and a
    resumed run would then drift from an uninterrupted one.  Here each
    distinct token's gradient row is one matrix product of a 0/1 matrix
    (distinct tokens x positions) with the positions' gradients, and the
    rows go to distinct table rows, so nothing is accumulated twice in
    one place.  The port's training path is deterministic by this
    formulation, not by ``torch.use_deterministic_algorithms``.  The
    product costs 2 x distinct tokens x positions x d_model operations:
    21 GFLOP for stablelm-3b's 2 x 1024 tokens, growing with the square
    of the batch's tokens."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.table_shape = table.shape
        return table[tokens]

    @staticmethod
    def backward(ctx, grad):
        tokens, = ctx.saved_tensors
        uniq, inv = torch.unique(tokens.reshape(-1), return_inverse=True)
        hits = (torch.arange(len(uniq), device=inv.device)[:, None]
                == inv[None, :]).to(grad.dtype)
        out = grad.new_zeros(ctx.table_shape)
        out[uniq] = hits @ grad.reshape(-1, grad.shape[-1])
        return out, None


def _embed(params: LanguageModel, cfg: ArchConfig, tokens: torch.Tensor,
           prefix_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The tokens' embeddings (B, S, D), with ``prefix_embeds`` (B, P, D)
    put before them where given: (B, P + S, D)."""
    x = (spmd.lookup(params.embed, tokens) if spmd.is_dtensor(params.embed)
         else _Lookup.apply(params.embed, tokens))
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    return x


def _logits(params: LanguageModel, cfg: ArchConfig,
            x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(cfg.norm, x, params.final_norm)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return x @ head


def encode(params: LanguageModel, cfg: ArchConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """The audio family's encoder: frame embeddings (B, S_enc, D)
    through the non-causal layers, every frame valid; no final norm, as
    in the reference."""
    for layer in params.enc_layers:
        frames, _ = layer(frames, causal=False)
    return frames


def dims_from_params(params: LanguageModel, cfg: ArchConfig) -> ModelDims:
    """Head counts as initialized, from the ``wq``/``wk`` widths of the
    dense, MoE, VLM and audio families' (decoder) layers or the hybrid's
    shared block (head padding included).  The SSM family has no
    attention and no head padding, so they are the config's."""
    if cfg.family == SSM:
        return ModelDims(cfg.n_heads, cfg.n_kv_heads, cfg.hd)
    attn = (params.shared_attn.attn if cfg.family == HYBRID
            else params.layers[0].attn)
    hd = cfg.hd
    return ModelDims(attn["wq"].shape[-1] // hd, attn["wk"].shape[-1] // hd,
                     hd)


def param_count_tree(params: LanguageModel) -> int:
    """The model's parameters, as the reference counts its tree's."""
    return sum(math.prod(t.shape) for t in params.parameters())


def _train_layer(layer: DenseBlock, x: torch.Tensor, dispatch: str
                 ) -> Tuple[torch.Tensor, Union[float, torch.Tensor]]:
    x, out = layer(x, dispatch=dispatch)
    return x, out["aux"]


def forward_train(params: LanguageModel, cfg: ArchConfig,
                  batch: Dict[str, torch.Tensor], *,
                  dispatch: str = "einsum", remat: bool = False,
                  chunk: int = 1024) -> torch.Tensor:
    """The training loss of ``batch`` (tokens and labels, (B, S) ints;
    the VLM family's ``prefix_embeds`` (B, P, D) float, put before the
    tokens): embedding, the layer stack, final norm, LM head over the
    padded vocab, the mean token cross-entropy over the token positions
    (the logits of the P prefix positions cut off, as the reference
    cuts them), plus 0.01 times the MoE layers' load-balancing loss
    summed over the layers, as the reference's.

    ``remat`` recomputes each layer's activations in the backward
    (``torch.utils.checkpoint``, non-reentrant), as ``jax.checkpoint``
    does.  ``chunk``, the KV chunk of the reference's ``jnp`` attention,
    is taken and unused: the kernel and its plain version tile KV
    themselves.  The hybrid and SSM families raise: their scans have no
    gradient yet; so does the audio family, whose training is not ported
    yet."""
    if cfg.family in (HYBRID, SSM):
        raise NotImplementedError(
            f"{cfg.name}: training the {cfg.family!r} family needs the SSD "
            f"scan's gradient, which is not ported yet (ROADMAP.md, "
            f"section 1 item 5: the hybrid, SSM and audio families' "
            f"training)")
    if cfg.family == AUDIO:
        raise NotImplementedError(
            f"{cfg.name}: training the {cfg.family!r} family (the encoder "
            f"and cross-attention under autograd, frames in the batch) is "
            f"not ported yet (ROADMAP.md, section 1 item 5: the hybrid, "
            f"SSM and audio families' training)")
    del chunk
    prefix = batch.get("prefix_embeds")
    x = _embed(params, cfg, batch["tokens"], prefix)
    aux: Union[float, torch.Tensor] = 0.0
    for layer in params.layers:
        if remat:
            x, a = checkpoint(_train_layer, layer, x, dispatch,
                              use_reentrant=False)
        else:
            x, a = _train_layer(layer, x, dispatch)
        aux = aux + a
    logits = _logits(params, cfg, x)
    if prefix is not None:
        logits = logits[:, prefix.shape[1]:]
    loss = cross_entropy_loss(logits, batch["labels"])
    return loss + 0.01 * aux

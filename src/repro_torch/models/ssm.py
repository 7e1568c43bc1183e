"""Recurrent blocks: the SSD scan, Mamba2 (the hybrid family), mLSTM and
sLSTM (the SSM family, xLSTM), the counterparts of
``repro/models/ssm.py``.

Mamba2's sequence mixing is the SSD scan with B/C shared across heads,
and mLSTM's matrix memory is gated linear attention whose two scans
(numerator and denominator) are SSD scans too; with heads folded into
the batch, every prefill scan goes through ``kernels/ssm_scan`` — the
hand-written CUDA kernel on the GPU, its plain chunked version on the
CPU.  The single-token decode step of either is one plain recurrence
step, as in the reference.  sLSTM is strictly sequential by
construction and runs as a loop over time in plain torch (the
reference's ``lax.scan``; no Pallas kernel there either).

Simplifications as in the reference: one SSM group (B/C shared across
heads); sigmoid input gating instead of the exponential-gate
max-stabilizer.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.kernels.ssm_scan import ssd_ref as _ssd_ref_folded
from . import spmd
from .layers import apply_norm, dense_init, mlp_apply, mlp_init, rmsnorm

Params = Dict[str, torch.Tensor]
HEAD_P = 64     # Mamba2's head width: the reference's default, never changed


# ----------------------------------------------------------- SSD (Mamba2)
def _fold(x, loga, dt, Bm, Cm, h0):
    """(B, S, H, ...) inputs with B/C shared across heads -> the kernel's
    head-folded (B*H, S, ...) layout."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]

    def heads(t):
        return t.movedim(2, 1).reshape(Bsz * H, S, -1)

    def shared(t):
        return t[:, None].expand(Bsz, H, S, N).reshape(Bsz * H, S, N)

    return (heads(x), heads(loga[..., None]), heads(dt[..., None]),
            shared(Bm), shared(Cm),
            None if h0 is None else h0.reshape(Bsz * H, N, P))


def _unfold(y, h, Bsz, H):
    S, P = y.shape[1:]
    return (y.reshape(Bsz, H, S, P).movedim(1, 2),
            h.reshape(Bsz, H, *h.shape[1:]))


def ssd_chunked(x: torch.Tensor, loga: torch.Tensor, dt: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 128,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunkwise selective-state-space scan, through ``ssm_scan``.

    x (B, S, H, P); loga, dt (B, S, H); Bm, Cm (B, S, N) shared across
    heads; h0 (B, H, N, P).  Returns (y (B, S, H, P), h_final (B, H, N,
    P)); chunks of ``min(chunk, S)`` tokens, which must divide S.
    DTensors scan on each device's shards (:func:`.spmd.ssd`).
    """
    if spmd.is_dtensor(x):
        return spmd.ssd(ssd_chunked, x, loga, dt, Bm, Cm, h0, chunk=chunk)
    Bsz, _, H, _ = x.shape
    *args, h0f = _fold(x, loga, dt, Bm, Cm, h0)
    y, h = ssm_scan(*args, chunk=chunk, h0=h0f)
    return _unfold(y, h, Bsz, H)


def ssd_ref(x, loga, dt, Bm, Cm, h0=None):
    """Sequential reference of :func:`ssd_chunked` (one step a token)."""
    Bsz, _, H, _ = x.shape
    y, h = _ssd_ref_folded(*_fold(x, loga, dt, Bm, Cm, h0))
    return _unfold(y, h, Bsz, H)


# ------------------------------------------------------------ Mamba2 block
def mamba2_init(gen: torch.Generator, d_model: int, *, expand: int,
                d_state: int, conv_k: int,
                dtype: torch.dtype = torch.float32) -> Params:
    d_in = expand * d_model
    nh = d_in // HEAD_P
    return {
        "in_proj": dense_init(gen, (d_model, 2 * d_in + 2 * d_state + nh),
                              dtype),
        "conv_w": dense_init(gen, (conv_k, d_in + 2 * d_state), dtype,
                             scale=1.0 / math.sqrt(conv_k)),
        "conv_b": torch.zeros((d_in + 2 * d_state,), dtype=dtype),
        "A_log": torch.zeros((nh,), dtype=torch.float32),
        "D": torch.ones((nh,), dtype=torch.float32),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32),
        "gamma": torch.ones((d_in,), dtype=dtype),
        "out_proj": dense_init(gen, (d_in, d_model), dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d: x (B, S, C), w (K, C), b (C,); ``state``
    the K-1 inputs before x (zeros if None).  Returns (y (B, S, C), the
    last K-1 inputs: the next call's state)."""
    K, S = w.shape[0], x.shape[1]
    pad = (x.new_zeros((x.shape[0], K - 1, x.shape[2])) if state is None
           else state)
    xp = torch.cat([pad, x], dim=1)                          # (B,S+K-1,C)
    y = sum(xp[:, i:i + S] * w[i] for i in range(K)) + b
    return y, xp[:, -(K - 1):]


def mamba2_apply(p: Params, u: torch.Tensor, *, expand: int, d_state: int,
                 chunk: int = 128, state: Optional[dict] = None
                 ) -> Tuple[torch.Tensor, Optional[dict]]:
    """u (B, S, D), mixed in heads of ``HEAD_P``.  ``state`` {"conv" (B,
    K-1, C), "ssm" (B, H, N, HEAD_P)}: with it, a one-token input takes
    one recurrence step and a longer one scans from it (the SSD scan,
    through ``ssm_scan``, in chunks of ``min(chunk, S)`` tokens, which
    must divide S: ValueError otherwise).  Returns (out (B, S, D), the
    new state or None)."""
    B, S, D = u.shape
    d_in = expand * D
    nh = d_in // HEAD_P
    z, xbc, dt = torch.split(u @ p["in_proj"],
                             [d_in, d_in + 2 * d_state, nh], dim=-1)
    conv_state = state["conv"] if state else None
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xbc = F.silu(xbc)
    x, Bm, Cm = torch.split(xbc, [d_in, d_state, d_state], dim=-1)
    x = x.reshape(B, S, nh, HEAD_P)
    # F.softplus returns x itself above 20, where jax.nn.softplus
    # (logaddexp(x, 0)) differs from x by under 2e-9 relative
    dt = F.softplus(dt.float() + p["dt_bias"])
    loga = -torch.exp(p["A_log"]) * dt                       # (B,S,H)
    h0 = state["ssm"] if state else None
    if S == 1 and state is not None:
        # decode: a single recurrent step
        a = torch.exp(loga[:, 0]).float()
        upd = torch.einsum("bd,bhp->bhdp", Bm[:, 0].float(),
                           (x[:, 0] * dt[:, 0, :, None]).float())
        h = h0 * a[..., None, None] + upd
        y = torch.einsum("bd,bhdp->bhp", Cm[:, 0].float(), h)[:, None]
    else:
        y, h = ssd_chunked(x, loga, dt, Bm, Cm, chunk=chunk, h0=h0)
    y = y.to(x.dtype) + x * p["D"][:, None].to(x.dtype)
    y = y.reshape(B, S, d_in) * F.silu(z)
    y = rmsnorm(y, p["gamma"])
    out = (y @ p["out_proj"]).to(u.dtype)
    new_state = ({"conv": new_conv, "ssm": h}
                 if state is not None else None)
    return out, new_state


# -------------------------------------------------------------- mLSTM block
def mlstm_init(gen: torch.Generator, d_model: int, n_heads: int,
               dtype: torch.dtype = torch.float32) -> Params:
    d_in = 2 * d_model
    return {
        "wq": dense_init(gen, (d_model, d_in), dtype),
        "wk": dense_init(gen, (d_model, d_in), dtype),
        "wv": dense_init(gen, (d_model, d_in), dtype),
        "wi": dense_init(gen, (d_model, n_heads), dtype),
        "wf": dense_init(gen, (d_model, n_heads), dtype),
        "wo_gate": dense_init(gen, (d_model, d_in), dtype),
        "out_proj": dense_init(gen, (d_in, d_model), dtype),
    }


def mlstm_apply(p: Params, x: torch.Tensor, n_heads: int, *,
                chunk: int = 128, state: Optional[dict] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Matrix-memory LSTM as gated linear attention.  ``state`` holds the
    head-folded numerator and denominator states ``num`` (B*H, 1, hd,
    hd) and ``den`` (B*H, 1, hd, 1); with it, a one-token input takes
    one recurrence step and a longer one scans from it.  DTensors run
    on each device's batch rows (:func:`.spmd.batch_local`)."""
    if spmd.is_dtensor(x):
        return spmd.batch_local(mlstm_apply, p, x, state, n_heads=n_heads,
                                chunk=chunk)
    B, S, D = x.shape
    d_in = 2 * D
    hd = d_in // n_heads
    q = (x @ p["wq"]).reshape(B, S, n_heads, hd)
    k = (x @ p["wk"]).reshape(B, S, n_heads, hd) / math.sqrt(hd)
    v = (x @ p["wv"]).reshape(B, S, n_heads, hd)
    f = F.logsigmoid((x @ p["wf"]).float())                  # (B,S,H)
    i = torch.sigmoid((x @ p["wi"]).float())                 # (B,S,H)

    def fold(t):                       # (B, S, H, ...) -> (B*H, S, ...)
        return t.movedim(2, 1).reshape(B * n_heads, S, *t.shape[3:])

    kf, qf = fold(k), fold(q)
    lf, df = fold(f[..., None]), fold(i[..., None])          # (BH,S,1)

    def per_head_ssd(xh, h0):
        # numerator: C = sum decay * i * (k (x) v), y = q . C; the
        # denominator the same with v = 1.  Heads are folded into the
        # batch, the scan's own layout; the cache keeps a unit head axis
        xf = fold(xh)                                        # (BH,S,P)
        h0 = None if h0 is None else h0[:, 0]                # (BH,N,P)
        if S == 1 and state is not None:
            a = torch.exp(lf[:, 0]).float()                  # (BH,1)
            upd = torch.einsum("bd,bp->bdp", kf[:, 0].float(),
                               (xf[:, 0] * df[:, 0]).float())
            h = h0 * a[..., None] + upd
            y = torch.einsum("bd,bdp->bp", qf[:, 0].float(), h)[:, None]
        else:
            y, h = ssm_scan(xf, lf, df, kf, qf, chunk=chunk, h0=h0)
        return y.reshape(B, n_heads, S, -1).movedim(1, 2), h[:, None]

    h0_num = state["num"] if state else None
    h0_den = state["den"] if state else None
    num, h_num = per_head_ssd(v, h0_num)
    ones = torch.ones((B, S, n_heads, 1), dtype=x.dtype, device=x.device)
    den, h_den = per_head_ssd(ones, h0_den)
    y = (num / torch.clamp(torch.abs(den), min=1.0)).to(x.dtype)
    o = torch.sigmoid(x @ p["wo_gate"])
    out = ((y.reshape(B, S, d_in) * o) @ p["out_proj"]).to(x.dtype)
    new_state = ({"num": h_num, "den": h_den}
                 if state is not None else None)
    return out, new_state


# -------------------------------------------------------------- sLSTM block
GATES = ("i", "f", "z", "o")


def slstm_init(gen: torch.Generator, d_model: int,
               dtype: torch.dtype = torch.float32) -> Params:
    p = {}
    for g in GATES:
        p[f"w_{g}"] = dense_init(gen, (d_model, d_model), dtype)
        p[f"r_{g}"] = dense_init(gen, (d_model, d_model), dtype,
                                 scale=0.5 / math.sqrt(d_model))
        p[f"b_{g}"] = torch.zeros((d_model,), dtype=dtype)
    return p


def slstm_apply(p: Params, x: torch.Tensor, *,
                state: Optional[dict] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Strictly sequential scalar-memory LSTM: a loop over time.  The
    four gates' input and recurrent products are each one product with
    the gates' weights side by side.  DTensors run on each device's batch
    rows (:func:`.spmd.batch_local`)."""
    if spmd.is_dtensor(x):
        return spmd.batch_local(slstm_apply, p, x, state)
    B, S, D = x.shape
    if state is None:
        h = torch.zeros((B, D), dtype=torch.float32, device=x.device)
        c = torch.zeros((B, D), dtype=torch.float32, device=x.device)
        n = torch.ones((B, D), dtype=torch.float32, device=x.device)
    else:
        h, c, n = state["h"], state["c"], state["n"]

    wx = (x @ torch.cat([p[f"w_{g}"] for g in GATES], dim=1)
          + torch.cat([p[f"b_{g}"] for g in GATES])).float()   # (B,S,4D)
    r = torch.cat([p[f"r_{g}"].float() for g in GATES], dim=1)  # (D,4D)
    hs = []
    for t in range(S):
        pre_i, pre_f, pre_z, pre_o = (wx[:, t] + h @ r).split(D, dim=-1)
        i, f = torch.sigmoid(pre_i), torch.sigmoid(pre_f)
        c = f * c + i * torch.tanh(pre_z)
        n = f * n + i
        h = torch.sigmoid(pre_o) * (c / torch.clamp(n, min=1.0))
        hs.append(h)
    out = torch.stack(hs, dim=1).to(x.dtype)                 # (B,S,D)
    new_state = {"h": h, "c": c, "n": n} if state is not None else None
    return out, new_state


# ------------------------------------------------------------ layer modules
class Mamba2Block(nn.Module):
    """One pre-norm Mamba2 layer of the hybrid family, ``x +
    mamba2(norm(x))`` and no MLP; the parameters keep the reference's
    names (``ln``, ``mamba``)."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.ln = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype))
        self.mamba = nn.ParameterDict(mamba2_init(
            gen, cfg.d_model, expand=cfg.ssm_expand, d_state=cfg.ssm_state,
            conv_k=cfg.ssm_conv, dtype=dtype))

    def forward(self, x: torch.Tensor, state: Optional[dict] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
        cfg = self.cfg
        y, st = mamba2_apply(dict(self.mamba),
                             apply_norm(cfg.norm, x, self.ln),
                             expand=cfg.ssm_expand, d_state=cfg.ssm_state,
                             state=state)
        return x + y, st


class _Block(nn.Module):
    """One pre-norm layer: ``x + mixer(norm(x))``, then ``x +
    MLP(norm(x))``; the parameters keep the reference's names (``ln``,
    the mixer's dictionary, ``ln2``, ``mlp``)."""
    mixer = ""

    def __init__(self, cfg: ArchConfig, mixer: Params, gen: torch.Generator,
                 dtype: torch.dtype):
        super().__init__()
        D = cfg.d_model
        self.cfg = cfg
        self.ln = nn.Parameter(torch.ones(D, dtype=dtype))
        setattr(self, self.mixer, nn.ParameterDict(mixer))
        self.ln2 = nn.Parameter(torch.ones(D, dtype=dtype))
        self.mlp = nn.ParameterDict(mlp_init(
            gen, D, max(cfg.d_ff, 2 * D), cfg.activation, dtype))

    def forward(self, x: torch.Tensor, state: Optional[dict] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
        y, st = self.mix(dict(getattr(self, self.mixer)),
                         apply_norm(self.cfg.norm, x, self.ln), state)
        x = x + y
        x = x + mlp_apply(dict(self.mlp),
                          apply_norm(self.cfg.norm, x, self.ln2),
                          self.cfg.activation)
        return x, st


class MLSTMBlock(_Block):
    mixer = "mlstm"

    def __init__(self, cfg: ArchConfig, gen: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cfg, mlstm_init(gen, cfg.d_model, cfg.n_heads,
                                         dtype), gen, dtype)

    def mix(self, p, x, state):
        return mlstm_apply(p, x, self.cfg.n_heads, state=state)


class SLSTMBlock(_Block):
    mixer = "slstm"

    def __init__(self, cfg: ArchConfig, gen: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cfg, slstm_init(gen, cfg.d_model, dtype), gen,
                         dtype)

    def mix(self, p, x, state):
        return slstm_apply(p, x, state=state)

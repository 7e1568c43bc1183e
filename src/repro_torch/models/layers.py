"""Shared neural building blocks (plain PyTorch, parameters as explicit
dictionaries of tensors), the counterparts of ``repro/models/layers.py``.

Initial values come from an explicit :class:`torch.Generator`, drawn on
the generator's device, so a model is a function of its seed and its
device; they are not the reference's numbers (``jax.random`` draws
others), so tests load the reference's weights through :mod:`.convert`
instead, and a comparison of two devices hands one device's weights to
the other.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import spmd


def dense_init(gen: Optional[torch.Generator], shape: Sequence[int],
               dtype: torch.dtype = torch.float32,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated normal at +-2 standard deviations, scaled by ``scale``
    or 1/sqrt(fan_in), drawn from ``gen`` on its device (a 2.8B-parameter
    model takes minutes to draw on the CPU, moments on the GPU).  With
    no generator, nothing is drawn: the tensor is shape only, on the
    meta device."""
    if gen is None:
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    t = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (std * t).to(dtype)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * gamma.float()).to(x.dtype)


def layernorm(x: torch.Tensor, gamma: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * gamma.float()).to(x.dtype)


def apply_norm(kind: str, x: torch.Tensor,
               gamma: torch.Tensor) -> torch.Tensor:
    """The norm of ``kind``; a DTensor comes out with the batch's
    placements (:func:`.spmd.rows`), as each sub-layer takes it."""
    y = rmsnorm(x, gamma) if kind == "rmsnorm" else layernorm(x, gamma)
    return spmd.rows(y) if spmd.is_dtensor(y) else y


# --------------------------------------------------------------------- RoPE
def rope_freqs(hd: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., S, H, hd); positions (..., S) integers.  Rotates the two
    halves of each head against each other (``jnp.split(x, 2)``, not
    interleaved pairs), angles ``position * freq`` in float32 from the
    integer positions, and casts back."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ang = positions.to(torch.float32)[..., None] * freqs     # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                       # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------- MLP
def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, activation: str,
             dtype: torch.dtype = torch.float32,
             prefix_shape: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """``prefix_shape`` stacks the weights, as the MoE layer's experts
    (E, D, F) and (E, F, D)."""
    p = {"w_up": dense_init(gen, (*prefix_shape, d_model, d_ff), dtype),
         "w_down": dense_init(gen, (*prefix_shape, d_ff, d_model), dtype)}
    if activation == "swiglu":
        p["w_gate"] = dense_init(gen, (*prefix_shape, d_model, d_ff), dtype)
    return p


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``; a DTensor weight's product on each device's shards
    (:func:`.spmd.linear`)."""
    return spmd.linear(x, w) if spmd.is_dtensor(w) else x @ w


def mlp_apply(p: Dict[str, torch.Tensor], x: torch.Tensor,
              activation: str) -> torch.Tensor:
    if activation == "swiglu":
        h = F.silu(linear(x, p["w_gate"])) * linear(x, p["w_up"])
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(linear(x, p["w_up"]), approximate="tanh")
    return linear(h, p["w_down"])


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy in float32: logsumexp over the (padded)
    vocab less the gold logit; with ``mask``, the masked mean over at
    least one token."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    if spmd.is_dtensor(logits):
        # no gather over a vocabulary sharded over the model axis: each
        # device selects its own columns and the sums are reduced
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        hit = labels.long().unsqueeze(-1) == vocab
        gold = torch.where(hit, logits, 0.0).sum(dim=-1)
    else:
        gold = torch.take_along_dim(logits, labels.long()[..., None],
                                    dim=-1)[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()

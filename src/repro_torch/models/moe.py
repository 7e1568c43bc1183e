"""Mixture-of-Experts layer: top-k routing with two dispatch strategies,
the counterpart of ``repro/models/moe.py``.

* ``einsum``: GShard/Switch-style dense one-hot dispatch with per-group
  capacity; every expert runs all of its C capacity slots.
* ``sort``: the (token, slot) pairs sorted by expert id, each expert
  reading a fixed-capacity slice of the sorted buffer, the results
  scattered back; no one-hot products.

Both drop the same pairs when an expert's capacity C = ceil(T_g k cf /
E) overflows: a pair's rank within its expert follows the flattened
(token, slot) order of its group, by an integer cumsum (einsum) or a
stable argsort (sort).  Tokens are grouped per sequence in prefill and
the whole batch as one group in decode (``models.serving``).  The expert
products are plain ``torch.einsum``s, as the reference's are plain
``jnp.einsum``s outside any Pallas kernel; with TF32 off they stay full
float32.

Expert *placement* across shards is ``repro_torch.edgecache.experts``:
the layer consumes weights already permuted.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import spmd
from .layers import dense_init, mlp_apply, mlp_init

Params = Dict[str, object]


def moe_init(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             activation: str, dtype: torch.dtype = torch.float32, *,
             dense_ff: int = 0) -> Params:
    """The router (D, E), the experts' stacked FFN weights (E, D, F) and
    (E, F, D), and, with ``dense_ff``, a dense residual FFN beside them
    (arctic-480b's)."""
    p: Params = {
        "router": dense_init(gen, (d_model, n_experts), dtype),
        "experts": mlp_init(gen, d_model, d_ff, activation, dtype,
                            prefix_shape=(n_experts,)),
    }
    if dense_ff:
        p["dense"] = mlp_init(gen, d_model, dense_ff, activation, dtype)
    return p


def _top_k_gating(x: torch.Tensor, router: torch.Tensor, top_k: int,
                  mean: Optional[Callable] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (gate weights (G, T, k), expert ids (G, T, k), aux loss).
    ``mean`` takes the aux loss's means over (G, T) (default: of these
    groups alone)."""
    mean = mean or (lambda t: t.mean(dim=(0, 1)))
    logits = (x @ router).float()                            # (G, T, E)
    probs = torch.softmax(logits, dim=-1)
    # ids in descending probability, as jax.lax.top_k; the order of equal
    # probabilities is not promised on CUDA, and a float32 near-tie can
    # route a token to another expert there than on the CPU
    gates, ids = torch.topk(probs, top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch-style load-balancing auxiliary loss
    E = router.shape[-1]
    me = mean(probs)
    ce = mean(F.one_hot(ids[..., 0], E).float())
    aux = E * torch.sum(me * ce)
    return gates, ids, aux


def _capacity(tokens_per_group: int, n_experts: int, top_k: int,
              cf: float) -> int:
    return max(1, math.ceil(tokens_per_group * top_k * cf / n_experts))


def moe_apply_einsum(p: Params, x: torch.Tensor, *, top_k: int,
                     activation: str, capacity_factor: float = 1.25,
                     experts: Optional[slice] = None,
                     mean: Optional[Callable] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense one-hot dispatch.  x (G, T, D) grouped tokens; returns (y
    (G, T, D), aux).  ``experts``: the slice of the experts whose
    weights ``p`` holds (one device's, under expert parallelism; all by
    default); ``mean``: as :func:`_top_k_gating`'s."""
    G, T, D = x.shape
    E = p["router"].shape[-1]
    C = _capacity(T, E, top_k, capacity_factor)
    # the plain call keeps _top_k_gating's three arguments, as wrappers
    # of it (tests/test_torch_moe.py's) take them
    gates, ids, aux = (_top_k_gating(x, p["router"], top_k) if mean is None
                       else _top_k_gating(x, p["router"], top_k, mean))

    # position of each (token, slot) within its expert's capacity buffer:
    # an integer cumsum over the flattened T·k order, exact on any device
    onehot = F.one_hot(ids, E)                               # (G, T, k, E)
    flat = onehot.reshape(G, T * top_k, E)
    pos = torch.cumsum(flat, dim=1) - 1                      # (G, T·k, E)
    pos = (pos * flat).sum(-1).reshape(G, T, top_k)          # (G, T, k)
    keep = pos < C
    # jax.nn.one_hot gives zeros for a position past C, F.one_hot raises:
    # clamp it, the dropped pairs are zeroed by ``keep`` all the same
    disp = (onehot.to(x.dtype)[..., None]
            * F.one_hot(pos.clamp(max=C - 1), C).to(x.dtype)[..., None, :]
            * keep[..., None, None].to(x.dtype))             # (G, T, k, E, C)
    dispatch = disp.sum(2)                                   # (G, T, E, C)
    combine = (disp * gates[..., None, None].to(x.dtype)).sum(2)
    if experts is not None:     # this device's experts alone
        dispatch, combine = dispatch[:, :, experts], combine[:, :, experts]

    xe = torch.einsum("gtec,gtd->gecd", dispatch, x)         # (G, E, C, D)
    h = _expert_ffn(p["experts"], xe, activation)
    y = torch.einsum("gecd,gtec->gtd", h, combine)
    if "dense" in p:
        y = y + mlp_apply(p["dense"], x, activation)
    return y, aux


def _expert_ffn(pe: Dict[str, torch.Tensor], xe: torch.Tensor,
                activation: str) -> torch.Tensor:
    """Batched per-expert FFN.  xe (G, E, C, D); weights (E, D, F) and (E,
    F, D)."""
    if activation == "swiglu":
        h = (F.silu(torch.einsum("gecd,edf->gecf", xe, pe["w_gate"]))
             * torch.einsum("gecd,edf->gecf", xe, pe["w_up"]))
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(torch.einsum("gecd,edf->gecf", xe, pe["w_up"]),
                   approximate="tanh")
    return torch.einsum("gecf,efd->gecd", h, pe["w_down"])


def moe_apply_sort(p: Params, x: torch.Tensor, *, top_k: int,
                   activation: str, capacity_factor: float = 1.25
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based dispatch: no one-hot products.

    Each group's (token, slot) pairs are sorted by assigned expert; each
    expert reads a fixed-capacity slice of the sorted buffer (capacity
    overflow drops, like the einsum path); outputs scatter back.  The
    reference maps one group at a time; here every group at once.
    """
    G, T, D = x.shape
    E = p["router"].shape[-1]
    C = _capacity(T, E, top_k, capacity_factor)
    gates, ids, aux = _top_k_gating(x, p["router"], top_k)
    dev = x.device

    tk = T * top_k
    flat_ids = ids.reshape(G, tk)                            # expert of slot
    flat_gates = gates.reshape(G, tk)
    tok_of_slot = torch.arange(T, device=dev).repeat_interleave(top_k)
    order = torch.argsort(flat_ids, dim=-1, stable=True)
    sorted_ids = flat_ids.gather(1, order)
    sorted_tok = tok_of_slot[order]                          # (G, T·k)
    sorted_gates = flat_gates.gather(1, order)
    # rank within expert = position - first position of that expert
    idx = torch.arange(tk, device=dev)
    first = torch.searchsorted(
        sorted_ids, torch.arange(E, device=dev).expand(G, E).contiguous(),
        side="left")                                         # (G, E)
    rank = idx - first.gather(1, sorted_ids)
    keep = rank < C
    slot = torch.where(keep, sorted_ids * C + rank, E * C)   # E·C = trash
    rows = torch.arange(G, device=dev)[:, None]
    buf = torch.zeros((G, E * C + 1, D), dtype=x.dtype, device=dev)
    # every dropped pair writes the trash row E·C, so its index repeats and
    # CUDA's index_put_ keeps one of them, unspecified which; the row is
    # cut off below, so no result depends on it
    buf[rows, slot] = (x[rows, sorted_tok]
                       * keep[..., None].to(x.dtype))
    xe = buf[:, :E * C].reshape(G, E, C, D)
    h = _expert_ffn(p["experts"], xe, activation).reshape(G, E * C, D)
    contrib = (h[rows, slot.clamp(max=E * C - 1)]
               * (sorted_gates * keep)[..., None])           # (G, T·k, D)
    # each token receives its k pairs' terms onto zeros; at k = 2 the two
    # float sums 0 + a + b and 0 + b + a are equal, so the order in which
    # index_add_ adds them does not matter; at k > 2 it would, and on CUDA
    # that order is not deterministic
    y = torch.zeros((G * T, D), dtype=torch.float32, device=dev)
    y.index_add_(0, (rows * T + sorted_tok).reshape(-1),
                 contrib.reshape(G * tk, D).float())
    y = y.reshape(G, T, D).to(x.dtype)
    if "dense" in p:
        y = y + mlp_apply(p["dense"], x, activation)
    return y, aux


def moe_apply(p: Params, x: torch.Tensor, *, top_k: int, activation: str,
              capacity_factor: float = 1.25, dispatch: str = "einsum"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer through ``dispatch``; DTensors on each device's shards
    (:func:`.spmd.moe`, the einsum dispatch)."""
    if spmd.is_dtensor(x):
        return spmd.moe(moe_apply_einsum, p, x, top_k=top_k,
                        activation=activation,
                        capacity_factor=capacity_factor, dispatch=dispatch)
    fn = moe_apply_einsum if dispatch == "einsum" else moe_apply_sort
    return fn(p, x, top_k=top_k, activation=activation,
              capacity_factor=capacity_factor)


class MoELayer(nn.Module):
    """One MoE layer, its parameters under the reference's names
    (``router``, ``experts.{w_gate, w_up, w_down}``, ``dense.*``);
    calling it is :func:`moe_apply` on them."""

    def __init__(self, gen: torch.Generator, d_model: int, d_ff: int,
                 n_experts: int, activation: str,
                 dtype: torch.dtype = torch.float32, *, dense_ff: int = 0):
        super().__init__()
        p = moe_init(gen, d_model, d_ff, n_experts, activation, dtype,
                     dense_ff=dense_ff)
        self.router = nn.Parameter(p["router"])
        self.experts = nn.ParameterDict(p["experts"])
        if dense_ff:
            self.dense = nn.ParameterDict(p["dense"])

    def forward(self, x: torch.Tensor, *, top_k: int, activation: str,
                capacity_factor: float, dispatch: str = "einsum"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return moe_apply(self.params(), x, top_k=top_k,
                         activation=activation,
                         capacity_factor=capacity_factor, dispatch=dispatch)

    def params(self) -> Params:
        """The layer's parameter tree, as :func:`moe_apply` takes it."""
        p: Params = {"router": self.router, "experts": dict(self.experts)}
        if hasattr(self, "dense"):
            p["dense"] = dict(self.dense)
        return p

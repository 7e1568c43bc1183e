"""Error-feedback int8 gradient compression for the cross-pod axis, the
counterpart of ``repro/distributed/compression.py``.

int8 quantization cuts a gradient all-reduce's wire bytes 4x against
float32, and the error-feedback residual keeps the long-run update
unbiased: what the quantizer drops is replayed into the next step, so
errors do not accumulate.  The arithmetic is the reference's to the bit
on the CPU and on the card: ``scale = max(amax, 1e-12) / 127`` and
``round(x / scale)`` are true divisions by tensors (CUDA divides by a
Python scalar as a product with its reciprocal, one rounding off), and
``torch.round`` rounds half to even, as ``jnp.round`` does.

Trees are ``{name: tensor}`` dicts, as the port's parameters and
gradients are.  :func:`compressed_psum` is the reference's
``shard_map`` pattern over a ``torch.distributed`` process group: each
rank's int8 codes and float32 scale are gathered, then dequantized and
summed locally.
"""
from __future__ import annotations

import functools
from typing import Dict, Mapping, Tuple

import torch
import torch.distributed as dist

Tree = Dict[str, torch.Tensor]


@functools.lru_cache(maxsize=None)
def _code_max(device: torch.device) -> torch.Tensor:
    """127 as a 0-d float32 tensor on ``device``, made once: CUDA divides
    by a Python scalar (or a CPU one) as a product with its reciprocal,
    one rounding off the CPU's and the reference's scale."""
    return torch.tensor(127.0, device=device)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization.  Returns (int8 codes of
    ``x``'s shape, the float32 scale as a 0-d tensor)."""
    xf = x.float()
    amax = xf.abs().amax()
    scale = torch.clamp_min(amax, 1e-12) / _code_max(amax.device)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress(grad: torch.Tensor, residual: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback step: compress (grad + residual); the new residual
    is whatever the quantizer dropped.  Returns (codes, scale, new
    residual)."""
    target = grad.float() + residual
    q, scale = quantize_int8(target)
    sent = dequantize_int8(q, scale)
    return q, scale, target - sent


def ef_compress_tree(grads: Mapping[str, torch.Tensor],
                     residuals: Mapping[str, torch.Tensor]
                     ) -> Tuple[Tree, Tree]:
    """:func:`ef_compress` on each leaf; returns (dequantized gradients,
    new residuals), float32 and keyed like ``grads``.  The dequantized
    values are what the cross-pod all-reduce would carry."""
    sent: Tree = {}
    new_res: Tree = {}
    for name, g in grads.items():
        q, scale, new_res[name] = ef_compress(g, residuals[name])
        sent[name] = dequantize_int8(q, scale)
    return sent, new_res


def init_residuals(params: Mapping[str, torch.Tensor]) -> Tree:
    """Zero float32 residuals shaped like ``params``, on their devices."""
    return {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for name, p in params.items()}


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (the default group if
    None) as int8: each rank's codes (N x size bytes on the wire, against
    2 (N-1)/N x size x 4 for a ring float32 all-reduce) and its scale
    are gathered, and each rank dequantizes and sums them, in rank
    order, by the reference's ``tensordot``."""
    q, scale = quantize_int8(x)
    n = dist.get_world_size(group)
    qg = torch.empty((n, q.numel()), dtype=torch.int8, device=q.device)
    sg = torch.empty((n, 1), dtype=torch.float32, device=q.device)
    # one row a rank (gloo gathers along the first dimension only)
    dist.all_gather_into_tensor(qg, q.reshape(1, -1), group=group)
    dist.all_gather_into_tensor(sg, scale.reshape(1, 1), group=group)
    out = torch.tensordot(sg.reshape(n), qg.float(), dims=([0], [0]))
    return out.reshape(x.shape)

"""AdamW with decoupled weight decay, after ``repro/optim/adamw.py``.

Parameters, gradients and the state's moments are dicts of tensors keyed
by the model's parameter names (``dict(model.named_parameters())``).
The arithmetic is the reference's, not ``torch.optim.AdamW``'s (which
decays as ``p *= 1 - lr wd`` and divides by ``sqrt(v̂)``): ``step =
(m / bc1) / (sqrt(v / bc2) + eps) + wd p``, ``p -= lr step``, with
``bc = 1 - b ** count`` in float32.  ``update`` writes the parameters and
the moments in place, so that a 2.8B-parameter model keeps one copy of
each; it returns the same dicts.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

Params = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Params], dict]
    update: Callable[[Params, dict, Params], Tuple[Params, dict]]


def zero_count(params: Params) -> torch.Tensor:
    """The step count, a 0-d int32 on the parameters' device."""
    dev = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=dev)


def adamw(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1
          ) -> Optimizer:
    """``lr``: a number or a function of the step count (a 0-d int32
    tensor, 1 at the first update), as :func:`.schedule.cosine_schedule`
    gives.  State: {"m", "v"} float32 moments keyed like the parameters,
    and "count"."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params: Params) -> dict:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": {n: zeros(p) for n, p in params.items()},
                "v": {n: zeros(p) for n, p in params.items()},
                "count": zero_count(params)}

    @torch.no_grad()
    def update(grads: Params, state: dict, params: Params
               ) -> Tuple[Params, dict]:
        count = state["count"] + 1
        lr_t = lr_fn(count)
        bc1 = 1 - b1 ** count.float()
        bc2 = 1 - b2 ** count.float()
        for name, p in params.items():
            g32 = grads[name].float()
            m, v = state["m"][name], state["v"][name]
            m.copy_(b1 * m + (1 - b1) * g32)
            v.copy_(b2 * v + (1 - b2) * g32 * g32)
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            step = step + weight_decay * p.float()
            p.copy_((p.float() - lr_t * step).to(p.dtype))
        state["count"] = count
        return params, state

    return Optimizer(init, update)

"""Adafactor (factored second moment, no first moment), after
``repro/optim/adafactor.py``: the optimizer above 20B parameters, its
state O(sum of dims) instead of O(prod of dims).

The reference's update depends on its tree's layout: a layer stack is
one leaf with a leading layer axis, so its 1-d weights are factored and
the update's RMS clip is taken over the whole stack.  So each step
groups the port's per-layer parameters into the reference's leaves
(``convert.reference_leaves``), stacks them, updates the stack and
writes the layers back in place.  The state's "f" is keyed by the
reference's leaf key ("layers/attn/wq") and holds that leaf's "vr" and
"vc", or "v" where it is 1-d.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models import spmd
from repro_torch.models.convert import reference_leaf, reference_leaves
from .adamw import Optimizer, Params, zero_count


def _stacked(names) -> bool:
    return reference_leaf(names[0])[1] is not None


def adafactor(lr=1e-3, decay=0.8, eps=1e-30, clip_threshold=1.0
              ) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def leaf(tensors: Params, names) -> torch.Tensor:
        return (torch.stack([tensors[n] for n in names]) if _stacked(names)
                else tensors[names[0]])

    def init(params: Params) -> dict:
        def state_for(p):
            z = dict(dtype=torch.float32, device=p.device)
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], **z),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
            return {"v": torch.zeros(p.shape, **z)}
        return {"f": {key: state_for(leaf(params, names).detach())
                      for key, names in reference_leaves(params).items()},
                "count": zero_count(params)}

    @torch.no_grad()
    def update(grads: Params, state: dict, params: Params
               ) -> Tuple[Params, dict]:
        count = state["count"] + 1
        beta = 1.0 - count.float() ** (-decay)
        lr_t = lr_fn(count)
        for key, names in reference_leaves(params).items():
            g32 = leaf(grads, names).float()
            p = leaf(params, names)
            s = state["f"][key]
            g2 = g32 * g32 + eps
            if g32.dim() >= 2:
                vr = beta * s["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * s["vc"] + (1 - beta) * g2.mean(dim=-2)
                denom = vr.mean(dim=-1, keepdim=True)
                r = (vr / torch.clamp(denom, min=eps))[..., None]
                c = vc[..., None, :]
                u = g32 * torch.rsqrt(torch.clamp(r * c, min=eps))
                state["f"][key] = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g32 * torch.rsqrt(torch.clamp(v, min=eps))
                state["f"][key] = {"v": v}
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            new = (p.float() - lr_t * u).to(p.dtype)
            if spmd.is_dtensor(new):    # the stack's shards, layer axis whole
                new = spmd.like(new, p)
            for name, t in zip(names, new if _stacked(names) else [new]):
                params[name].copy_(t)
        state["count"] = count
        return params, state

    return Optimizer(init, update)

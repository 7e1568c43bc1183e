"""Learning-rate schedule and gradient clipping, after
``repro/optim/schedule.py``."""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1):
    """Linear warmup to ``peak_lr``, then a cosine down to ``floor_frac``
    of it at ``total``; a function of the step (a number or a tensor)
    returning a float32 tensor."""
    def lr(step):
        dev = step.device if isinstance(step, torch.Tensor) else None
        step = step.float() if isinstance(step, torch.Tensor) else float(
            step)
        warm = torch.as_tensor(peak_lr * step / max(warmup, 1),
                               dtype=torch.float32, device=dev)
        t = torch.clamp(torch.as_tensor(
            (step - warmup) / max(total - warmup, 1), dtype=torch.float32,
            device=dev), 0.0, 1.0)
        cos = peak_lr * (floor_frac + (1 - floor_frac) * 0.5 *
                         (1 + torch.cos(math.pi * t)))
        return torch.where(torch.as_tensor(step < warmup, device=dev),
                           warm, cos)
    return lr


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Gradients scaled to a global norm of at most ``max_norm``, and the
    norm before scaling: the square root of the sum of each tensor's
    float32 sum of squares."""
    gn = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return {n: (g.float() * scale).to(g.dtype)
            for n, g in grads.items()}, gn

"""Step functions, the counterparts of ``repro/train/steps.py``: one
training step (loss and gradients through autograd, clipping, the
optimizer's update) and thin wrappers over the port's serving for
prefill and decode."""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import (LanguageModel, decode_step, forward_train,
                                prefill)
from repro_torch.optim import for_arch
from repro_torch.optim.schedule import clip_by_global_norm


def make_train_step(cfg: ArchConfig, optimizer=None, *,
                    dispatch: str = "einsum", remat: bool = True,
                    chunk: int = 1024, grad_clip: float = 1.0
                    ) -> Tuple[Callable, Any]:
    """``(train_step, optimizer)``.  ``train_step(params, opt_state,
    batch)`` takes the model, the optimizer's state (``opt.init(dict(
    params.named_parameters()))``) and a batch of (B, S) int64 "tokens"
    and "labels" on the model's device; it updates the parameters and the
    state in place and returns ``(params, opt_state, {"loss",
    "grad_norm"})``, the metrics as 0-d tensors on the device."""
    opt = optimizer or for_arch(cfg.param_count())

    def train_step(params: LanguageModel, opt_state, batch):
        named = dict(params.named_parameters())
        loss = forward_train(params, cfg, batch, dispatch=dispatch,
                             remat=remat, chunk=chunk)
        grads = dict(zip(named, torch.autograd.grad(loss,
                                                    list(named.values()))))
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        _, opt_state = opt.update(grads, opt_state, named)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step, opt


def make_prefill_step(cfg: ArchConfig, *, dispatch: str = "einsum",
                      max_len: Optional[int] = None,
                      chunk: int = 1024) -> Callable:
    """``prefill_step(params, batch) -> (last-position logits (B, V),
    cache)`` over ``batch["tokens"]``; ``chunk`` is unused, as in
    ``forward_train``."""
    del chunk

    def prefill_step(params: LanguageModel, batch: Dict[str, torch.Tensor]):
        logits, cache = prefill(params, cfg, batch["tokens"],
                                max_len=max_len, dispatch=dispatch)
        # serving returns only the last-position logits (next-token head)
        return logits[:, -1], cache

    return prefill_step


def make_decode_step(cfg: ArchConfig, *, dispatch: str = "einsum"
                     ) -> Callable:
    def serve_step(params: LanguageModel, cache, tokens: torch.Tensor):
        return decode_step(params, cfg, cache, tokens, dispatch=dispatch)

    return serve_step

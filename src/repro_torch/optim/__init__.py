"""Optimizers after the reference's arithmetic (``repro/optim``), on
dicts of tensors keyed by the model's parameter names."""
from .adamw import Optimizer, adamw
from .adafactor import adafactor
from .schedule import clip_by_global_norm, cosine_schedule

__all__ = ["Optimizer", "adafactor", "adamw", "clip_by_global_norm",
           "cosine_schedule", "for_arch"]


def for_arch(param_count: int, lr=None) -> Optimizer:
    """Deployment policy: factored optimizer state above 20B parameters
    (the Adam moments of a 480B model fit no card), AdamW below."""
    if param_count > 20e9:
        return adafactor(lr or 1e-3)
    return adamw(lr or 3e-4)

"""Where the port's entry points run: the GPU unless the caller names
another device."""
from __future__ import annotations

import torch


def resolve_device(device=None, entry: str = "the port") -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means the GPU.  No
    silent CPU fallback: with no GPU visible and none or a CUDA device
    named, this raises, naming ``entry``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{entry} runs on the GPU by default and no CUDA device is "
            "visible; pass device='cpu' to run the plain versions on the "
            "CPU")
    return dev

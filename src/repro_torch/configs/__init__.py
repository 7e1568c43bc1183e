"""Config registry: ``--arch <id>`` resolves here."""
from typing import Dict, List

from .base import (ArchConfig, ShapeConfig, SHAPES, supports_shape, reduced,
                   DENSE, MOE, SSM, HYBRID, AUDIO, VLM)

from . import (seamless_m4t_large_v2, zamba2_1p2b, deepseek_coder_33b,
               granite_20b, phi3_medium_14b, stablelm_3b, arctic_480b,
               mixtral_8x7b, xlstm_125m, internvl2_76b)

_MODULES = [
    seamless_m4t_large_v2, zamba2_1p2b, deepseek_coder_33b, granite_20b,
    phi3_medium_14b, stablelm_3b, arctic_480b, mixtral_8x7b, xlstm_125m,
    internvl2_76b,
]

REGISTRY: Dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}

ALL_ARCHS: List[str] = list(REGISTRY)


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {', '.join(REGISTRY)}")
    return REGISTRY[name]


__all__ = [
    "ArchConfig", "ShapeConfig", "SHAPES", "supports_shape", "reduced",
    "REGISTRY", "ALL_ARCHS", "get_config",
    "DENSE", "MOE", "SSM", "HYBRID", "AUDIO", "VLM",
]

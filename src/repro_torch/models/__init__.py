"""The LLM side stack's models in PyTorch (the dense, MoE, hybrid and SSM
families so far)."""
from .model import (LanguageModel, ModelDims, dims_from_params, init_params,
                    padded_vocab)
from .serving import decode_step, init_cache, prefill

__all__ = ["LanguageModel", "ModelDims", "decode_step", "dims_from_params",
           "init_cache", "init_params", "padded_vocab", "prefill"]

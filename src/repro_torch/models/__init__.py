"""The LLM side stack's models in PyTorch (the dense, MoE, VLM, audio,
hybrid and SSM families; training for the dense, MoE and VLM
families)."""
from .model import (LanguageModel, ModelDims, dims_from_params, encode,
                    forward_train, init_params, padded_vocab,
                    param_count_tree)
from .serving import decode_step, init_cache, prefill

__all__ = ["LanguageModel", "ModelDims", "decode_step", "dims_from_params",
           "encode", "forward_train", "init_cache", "init_params",
           "padded_vocab", "param_count_tree", "prefill"]

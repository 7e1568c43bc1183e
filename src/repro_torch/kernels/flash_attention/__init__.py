from .kernel import flash_fwd
from .ops import flash_attention
from .ref import flash_attention_chunked_ref, flash_attention_ref

__all__ = ["flash_attention", "flash_attention_chunked_ref",
           "flash_attention_ref", "flash_fwd"]

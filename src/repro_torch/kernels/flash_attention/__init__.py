from .kernel import flash_fwd
from .ops import FlashAttention, attention_grads, flash_attention
from .ref import flash_attention_chunked_ref, flash_attention_ref

__all__ = ["FlashAttention", "attention_grads", "flash_attention",
           "flash_attention_chunked_ref", "flash_attention_ref", "flash_fwd"]

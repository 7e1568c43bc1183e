"""internvl2-76b — VLM: InternViT frontend (STUB) + InternLM2-style LM.
[arXiv:2404.16821; unverified]. 80L, d_model=8192, 64H (GQA kv=8),
d_ff=28672, vocab=128256. Per the assignment the modality frontend is a
stub: ``input_specs()`` provides 256 precomputed patch embeddings that are
prepended to the token stream.
"""
from .base import ArchConfig, VLM

CONFIG = ArchConfig(
    name="internvl2-76b",
    family=VLM,
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28_672,
    vocab_size=128_256,
    frontend="vision",
    frontend_tokens=256,
    activation="swiglu",
    source="arXiv:2404.16821; unverified",
)

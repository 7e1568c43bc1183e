"""mixtral-8x7b — 8-expert top-2 MoE with sliding-window attention.
[arXiv:2401.04088; hf]. 32L, d_model=4096, 32H (GQA kv=8), d_ff=14336,
vocab=32000, window=4096. SWA makes decode memory O(window) — so this MoE
arch legitimately runs the long_500k shape (sub-quadratic per assignment).
"""
from .base import ArchConfig, MOE

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family=MOE,
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=32_000,
    n_experts=8,
    top_k=2,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    activation="swiglu",
    source="arXiv:2401.04088; hf",
)

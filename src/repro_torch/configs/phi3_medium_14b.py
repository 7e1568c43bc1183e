"""phi3-medium-14b — dense, RoPE + SwiGLU + GQA.
[arXiv:2404.14219; unverified]. 40L, d_model=5120, 40H (GQA kv=10),
d_ff=17920, vocab=100352. 40 heads pad to 48 on a 16-way model axis.
"""
from .base import ArchConfig, DENSE

CONFIG = ArchConfig(
    name="phi3-medium-14b",
    family=DENSE,
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17_920,
    vocab_size=100_352,
    activation="swiglu",
    source="arXiv:2404.14219; unverified",
)

"""stablelm-3b — dense decoder.
[hf:stabilityai/stablelm-2-1_6b; unverified]. 32L, d_model=2560, 32H
(GQA kv=32), d_ff=6912, vocab=50304.
"""
from .base import ArchConfig, DENSE

CONFIG = ArchConfig(
    name="stablelm-3b",
    family=DENSE,
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab_size=50_304,
    activation="swiglu",
    source="hf:stabilityai/stablelm-2-1_6b; unverified",
)

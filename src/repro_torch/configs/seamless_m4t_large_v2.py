"""seamless-m4t-large-v2 — enc-dec multimodal (audio) backbone.
[arXiv:2308.11596; hf]. 24L, d_model=1024, 16H (GQA kv=16), d_ff=8192,
vocab=256206. The audio frontend is a STUB: ``input_specs()`` supplies
precomputed frame embeddings (assignment note); we model 24 encoder +
24 decoder layers with cross-attention.
"""
from .base import ArchConfig, AUDIO

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family=AUDIO,
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256_206,
    encoder_layers=24,
    frontend="audio",
    frontend_tokens=0,       # encoder input IS the frame-embedding stub
    activation="swiglu",
    source="arXiv:2308.11596; hf",
)

"""granite-20b — dense llama-arch code model with MQA (kv=1).
[arXiv:2405.04324; hf]. 52L, d_model=6144, 48H (GQA kv=1), d_ff=24576,
vocab=49152. MQA makes the decode KV cache ~48x smaller than MHA — the
memory-roofline case study among the dense archs.
"""
from .base import ArchConfig, DENSE

CONFIG = ArchConfig(
    name="granite-20b",
    family=DENSE,
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24_576,
    vocab_size=49_152,
    activation="swiglu",
    source="arXiv:2405.04324; hf",
)

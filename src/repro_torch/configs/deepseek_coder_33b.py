"""deepseek-coder-33b — dense llama-arch code model.
[arXiv:2401.14196; hf]. 62L, d_model=7168, 56H (GQA kv=8), d_ff=19200,
vocab=32256. 56 heads pad to 64 on a 16-way model axis (see configs.base).
"""
from .base import ArchConfig, DENSE

CONFIG = ArchConfig(
    name="deepseek-coder-33b",
    family=DENSE,
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19_200,
    vocab_size=32_256,
    rope_theta=100_000.0,
    activation="swiglu",
    source="arXiv:2401.14196; hf",
)

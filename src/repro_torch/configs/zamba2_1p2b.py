"""zamba2-1.2b — hybrid Mamba2 + shared attention blocks.
[arXiv:2411.15242; hf]. 38L, d_model=2048, 32H (GQA kv=32), d_ff=8192,
vocab=32000, ssm_state=64. One *shared-weight* attention block is applied
every 6 Mamba2 blocks (the Zamba trick: a single attn block's weights are
reused at each application point).
"""
from .base import ArchConfig, HYBRID

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family=HYBRID,
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32_000,
    ssm_state=64,
    ssm_expand=2,
    ssm_conv=4,
    shared_attn_every=6,
    activation="swiglu",
    source="arXiv:2411.15242; hf",
)

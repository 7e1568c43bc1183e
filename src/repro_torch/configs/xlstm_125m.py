"""xlstm-125m — sLSTM + mLSTM blocks.
[arXiv:2405.04517; unverified]. 12L, d_model=768, 4H, vocab=50304. d_ff=0
in the assignment: blocks carry their own projection FFNs (we use the
xLSTM paper's up-projection factor 2). Blocks 0 and 6 are sLSTM (scalar
memory, strictly sequential), the rest mLSTM (matrix memory, chunkwise
parallel) — documented assumption; recurrent state is constant-size, so
long_500k runs.
"""
from .base import ArchConfig, SSM

CONFIG = ArchConfig(
    name="xlstm-125m",
    family=SSM,
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    slstm_layers=(0, 6),
    activation="gelu",
    source="arXiv:2405.04517; unverified",
)

"""arctic-480b — 128-expert top-2 MoE with a dense residual path.
[hf:Snowflake/snowflake-arctic-base; hf]. 35L, d_model=7168, 56H (GQA
kv=8), expert d_ff=4864, vocab=32000. The dense residual FFN runs in
parallel with the MoE layer (Arctic's dense-MoE hybrid); we set its width
to the same 4864 (documented choice — the assignment pins only the expert
d_ff). 56 heads pad to 64 on a 16-way model axis. EdgeKV tie-in: experts
are *global keys* placed on the consistent-hash ring with weighted virtual
nodes (DESIGN.md §3).
"""
from .base import ArchConfig, MOE

CONFIG = ArchConfig(
    name="arctic-480b",
    family=MOE,
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32_000,
    n_experts=128,
    top_k=2,
    moe_dense_residual=True,
    dense_ff=4864,
    activation="swiglu",
    source="hf:Snowflake/snowflake-arctic-base; hf",
)

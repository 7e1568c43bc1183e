"""Architecture & shape configuration system.

Every assigned architecture is a frozen :class:`ArchConfig`; the four
assigned input shapes are :class:`ShapeConfig`. ``--arch <id>`` resolves
through :func:`repro_torch.configs.get_config`.

TP divisibility: attention heads are padded up to the model-axis size where
the published head count doesn't divide it (deepseek 56H, phi3 40H,
arctic 56H -> 64H on a 16-way model axis). Padding is standard deployment
practice (zero-init extra heads); the roofline report carries the honest
MODEL_FLOPS (unpadded) so the waste is visible in the useful-FLOPs ratio.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

DENSE, MOE, SSM, HYBRID, AUDIO, VLM = (
    "dense", "moe", "ssm", "hybrid", "audio", "vlm")


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    # attention flavour
    sliding_window: int = 0           # 0 = full attention (mixtral: 4096)
    rope_theta: float = 10_000.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_dense_residual: bool = False  # arctic: dense FFN in parallel w/ MoE
    dense_ff: int = 0                 # width of that dense residual FFN
    capacity_factor: float = 1.25
    # SSM / recurrent
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    shared_attn_every: int = 0        # zamba2: shared attn block cadence
    slstm_layers: Tuple[int, ...] = ()  # xlstm: which blocks are sLSTM
    # encoder-decoder (seamless)
    encoder_layers: int = 0
    # modality frontend stub
    frontend: Optional[str] = None    # 'audio' | 'vision' | None
    frontend_tokens: int = 0          # prefix embeddings supplied by stub
    # norms / activations
    activation: str = "swiglu"
    norm: str = "rmsnorm"
    tie_embeddings: bool = False
    source: str = ""

    # ------------------------------------------------------------ derived
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def padded_heads(self, tp: int, pad_kv: bool = False) -> Tuple[int, int]:
        """(H, K) padded up to divide the tensor-parallel degree.

        ``pad_kv=True`` additionally pads K up to tp even when tp % K == 0
        (zero-init extra KV heads). This buys a cleanly head-sharded decode
        cache — no resharding inside the layer scan — at the cost of
        redundant K/V projection FLOPs (§Perf hillclimb 3)."""
        h = self.n_heads
        k = self.n_kv_heads
        if h % tp:
            h = math.ceil(h / tp) * tp
        if k % tp and tp % k:
            k = math.ceil(k / tp) * tp if k > 1 else k  # MQA stays 1
        if pad_kv and k > 1 and k % tp:
            k = math.ceil(k / tp) * tp
        return h, k

    @property
    def is_subquadratic(self) -> bool:
        return self.family in (SSM, HYBRID) or self.sliding_window > 0

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch has an autoregressive decoder

    # -------------------------------------------------------- param counts
    def param_count(self) -> int:
        """Exact parameter count of our implementation (unpadded)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        H, K, hd = self.n_heads, self.n_kv_heads, self.hd

        def attn() -> int:
            return D * H * hd + 2 * D * K * hd + H * hd * D

        def dense_mlp(f: int) -> int:
            per = 3 if self.activation == "swiglu" else 2
            return per * D * f

        def moe_mlp() -> int:
            return D * self.n_experts + self.n_experts * dense_mlp(F) + (
                dense_mlp(self.dense_ff) if self.moe_dense_residual else 0)

        def mamba_block() -> int:
            d_in = self.ssm_expand * D
            # in_proj (x,z), conv, B/C/dt proj, A/D, out_proj
            return (D * 2 * d_in + d_in * self.ssm_conv
                    + d_in * (2 * self.ssm_state + 1)
                    + 2 * d_in + d_in * D)

        def mlstm_block() -> int:
            d_in = 2 * D
            return D * 3 * d_in + 3 * d_in + d_in * D + dense_mlp(max(F, 2 * D))

        def slstm_block() -> int:
            return 4 * (D * D + D * D + D) + dense_mlp(max(F, 2 * D))

        total = 0
        if self.family in (DENSE, VLM):
            total += L * (attn() + dense_mlp(F) + 2 * D)
        elif self.family == AUDIO:
            # encoder (self-attn) + decoder (self + cross)
            total += self.encoder_layers * (attn() + dense_mlp(F) + 2 * D)
            total += L * (2 * attn() + dense_mlp(F) + 3 * D)
        elif self.family == MOE:
            total += L * (attn() + moe_mlp() + 2 * D)
        elif self.family == HYBRID:
            n_shared = (L // self.shared_attn_every
                        if self.shared_attn_every else 0)
            total += L * (mamba_block() + 2 * D) + (attn() + 2 * D)
        elif self.family == SSM:
            for i in range(L):
                total += (slstm_block() if i in self.slstm_layers
                          else mlstm_block()) + 2 * D
        total += V * D                       # token embedding
        if not self.tie_embeddings:
            total += D * V                   # lm head
        total += D                           # final norm
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if self.family != MOE:
            return self.param_count()
        D, F, L = self.d_model, self.d_ff, self.n_layers
        per = 3 if self.activation == "swiglu" else 2
        inactive = L * (self.n_experts - self.top_k) * per * D * F
        return self.param_count() - inactive


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def supports_shape(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Assignment policy: long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k" and not arch.is_subquadratic:
        return False, ("pure full-attention architecture: 500k-token decode "
                       "KV cache is quadratic-cost; skipped per assignment "
                       "(see DESIGN.md §5)")
    return True, ""


def reduced(arch: ArchConfig) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    kw = dict(
        n_layers=min(arch.n_layers, 4),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(4, max(1, arch.n_kv_heads * 4 // arch.n_heads)),
        d_ff=128 if arch.d_ff else 0,
        vocab_size=256,
        head_dim=16,
    )
    if arch.n_experts:
        kw["n_experts"] = 4
        kw["top_k"] = min(2, arch.top_k)
        # generous capacity so reduced-config prefill/decode paths route
        # identically (capacity drops are exercised by the moe unit tests)
        kw["capacity_factor"] = 8.0
    if arch.dense_ff:
        kw["dense_ff"] = 96
    if arch.ssm_state:
        kw["ssm_state"] = 16
    if arch.shared_attn_every:
        kw["shared_attn_every"] = 2
        kw["n_layers"] = 4
    if arch.slstm_layers:
        kw["slstm_layers"] = (0,)
        kw["n_layers"] = 3
    if arch.encoder_layers:
        kw["encoder_layers"] = 2
    if arch.sliding_window:
        kw["sliding_window"] = 16
    if arch.frontend_tokens:
        kw["frontend_tokens"] = 8
    return replace(arch, name=arch.name + "-smoke", **kw)

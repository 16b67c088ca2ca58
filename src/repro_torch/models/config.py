"""Model configuration schema for the assigned architecture pool.

One frozen dataclass covers all five families (dense / moe / hybrid-rglru /
rwkv6 / frontend-stub VLM + audio); family-specific fields are zeroed when
unused.  `src/repro/configs/<arch>.py` instantiates one of these per assigned
architecture with the exact published numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "hybrid_rglru", "rwkv6", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int          # query heads (0 for attention-free families)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qkv_bias: bool = False

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0       # per-expert hidden dim (d_ff covers dense layers)
    moe_every: int = 1      # 2 = alternate dense/MoE FFN layers (llama4)

    # --- hybrid (recurrentgemma): repeating block pattern ---
    # pattern entries: "rglru" | "local" ; empty = homogeneous attention
    block_pattern: tuple[str, ...] = ()
    local_window: int = 2048
    rglru_dim: int = 0      # recurrence width (defaults to d_model)

    # --- rwkv6 ---
    rwkv_head_size: int = 64

    # --- positional encoding ---
    rope_theta: float = 1_000_000.0
    mrope_sections: tuple[int, int, int] = ()  # M-RoPE (qwen2-vl): t/h/w

    # --- modality frontend stubs ---
    frontend: str | None = None   # None | "vision" | "audio"
    num_codebooks: int = 1        # musicgen EnCodec codebooks

    # --- numerics ---
    param_dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    def __post_init__(self) -> None:
        if self.family in ("dense", "moe", "vlm", "audio"):
            assert self.num_heads > 0 and self.num_kv_heads > 0
            assert self.num_heads % self.num_kv_heads == 0
        if self.family == "moe":
            assert self.num_experts > 0 and self.experts_per_token > 0
        if self.family == "hybrid_rglru":
            assert self.block_pattern, "hybrid family needs a block pattern"

    # ---- derived ----------------------------------------------------------

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def attends(self) -> bool:
        """False for fully attention-free families (rwkv6)."""
        return self.family != "rwkv6"

    @property
    def sub_quadratic(self) -> bool:
        """True when long_500k decode is admissible (DESIGN.md §4)."""
        return self.family in ("rwkv6", "hybrid_rglru")

    @property
    def num_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "rwkv6":
            # time-mix (r,k,v,w,g,o ~ 6 d^2) + channel-mix (~ 2*3.5 d^2)
            per_layer = 6 * d * d + 2 * d * f
        else:
            h, kv, hd = self.num_heads, self.num_kv_heads, self.head_dim
            attn = d * h * hd + 2 * d * kv * hd + h * hd * d
            if self.family == "moe":
                moe = self.num_experts * 3 * d * self.moe_d_ff
                dense = 3 * d * f
                n_moe = self.num_layers // self.moe_every
                return (emb + self.num_layers * attn + n_moe * moe
                        + (self.num_layers - n_moe) * dense)
            else:
                ffn = 3 * d * f
            if self.family == "hybrid_rglru":
                n_rec = sum(1 for p in self._full_pattern() if p == "rglru")
                n_att = self.num_layers - n_rec
                rec = 6 * d * d  # gates + recurrence + projections (approx)
                return emb + n_rec * (rec + 3 * d * f) + n_att * (attn + 3 * d * f)
            per_layer = attn + ffn
        return emb + self.num_layers * per_layer

    def active_param_count(self) -> int:
        """Activated params per token (= param_count for dense)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        h, kv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        moe_active = self.experts_per_token * 3 * d * self.moe_d_ff
        dense = 3 * d * self.d_ff
        n_moe = self.num_layers // self.moe_every
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return (emb + self.num_layers * attn + n_moe * moe_active
                + (self.num_layers - n_moe) * dense)

    def _full_pattern(self) -> tuple[str, ...]:
        """Expand block_pattern cyclically over num_layers."""
        if not self.block_pattern:
            return ("attn",) * self.num_layers
        reps = -(-self.num_layers // len(self.block_pattern))
        return (self.block_pattern * reps)[: self.num_layers]


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]

    @property
    def is_serve(self) -> bool:
        return self.kind in ("prefill", "decode")


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

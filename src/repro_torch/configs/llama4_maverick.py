"""Llama-4-Maverick-400B-A17B — MoE 128 experts top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe", num_layers=48,
    d_model=5120, num_heads=40, num_kv_heads=8, d_ff=8192,
    vocab_size=202048, head_dim=128, num_experts=128, experts_per_token=1,
    moe_d_ff=8192, moe_every=2, rope_theta=500_000.0,
)

REDUCED = ModelConfig(
    name="llama4-maverick-reduced", family="moe", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128, head_dim=16,
    num_experts=8, experts_per_token=1, moe_d_ff=128, moe_every=2,
    param_dtype="float32",
)

"""Granite-3.0-1B-A400M — MoE 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe", num_layers=24, d_model=1024,
    num_heads=16, num_kv_heads=8, d_ff=512, vocab_size=49155,
    head_dim=64, num_experts=32, experts_per_token=8, moe_d_ff=512,
    rope_theta=10_000.0,
)

REDUCED = ModelConfig(
    name="granite-moe-1b-a400m-reduced", family="moe", num_layers=2,
    d_model=64, num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=131,
    head_dim=16, num_experts=4, experts_per_token=2, moe_d_ff=64,
    param_dtype="float32",
)

"""Qwen2-VL-7B — M-RoPE, dynamic resolution (stub frontend)
[arXiv:2409.12191; hf].  Backbone only per assignment; ``input_specs``
provides precomputed patch embeddings."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm", num_layers=28, d_model=3584,
    num_heads=28, num_kv_heads=4, d_ff=18944, vocab_size=152064,
    head_dim=128, qkv_bias=True, rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24), frontend="vision",
)

REDUCED = ModelConfig(
    name="qwen2-vl-7b-reduced", family="vlm", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128, head_dim=16,
    qkv_bias=True, mrope_sections=(2, 3, 3), frontend="vision",
    param_dtype="float32",
)

"""Qwen2-72B — dense GQA with QKV bias [arXiv:2407.10671; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b", family="dense", num_layers=80, d_model=8192,
    num_heads=64, num_kv_heads=8, d_ff=29568, vocab_size=152064,
    head_dim=128, qkv_bias=True, rope_theta=1_000_000.0,
)

REDUCED = ModelConfig(
    name="qwen2-72b-reduced", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
    head_dim=16, qkv_bias=True, param_dtype="float32",
)

"""Qwen2-7B — dense GQA with QKV bias [arXiv:2407.10671; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b", family="dense", num_layers=28, d_model=3584,
    num_heads=28, num_kv_heads=4, d_ff=18944, vocab_size=152064,
    head_dim=128, qkv_bias=True, rope_theta=1_000_000.0,
)

REDUCED = ModelConfig(
    name="qwen2-7b-reduced", family="dense", num_layers=2, d_model=56,
    num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=128,
    head_dim=14, qkv_bias=True, param_dtype="float32",
)

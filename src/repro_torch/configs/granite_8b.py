"""Granite-8B-Code — llama-arch dense GQA [arXiv:2405.04324; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b", family="dense", num_layers=36, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=49152,
    head_dim=128, rope_theta=10_000_000.0,
)

REDUCED = ModelConfig(
    name="granite-8b-reduced", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
    head_dim=16, param_dtype="float32",
)

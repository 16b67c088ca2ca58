"""DeepSeek-67B — llama-arch dense GQA, 95 layers [arXiv:2401.02954; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense", num_layers=95, d_model=8192,
    num_heads=64, num_kv_heads=8, d_ff=22016, vocab_size=102400,
    head_dim=128, rope_theta=10_000.0,
)

REDUCED = ModelConfig(
    name="deepseek-67b-reduced", family="dense", num_layers=3, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
    head_dim=16, param_dtype="float32",
)

"""RWKV-6 (Finch) 7B — attention-free, data-dependent decay
[arXiv:2404.05892; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="rwkv6", num_layers=32, d_model=4096,
    num_heads=0, num_kv_heads=0, d_ff=14336, vocab_size=65536,
    rwkv_head_size=64,
)

REDUCED = ModelConfig(
    name="rwkv6-7b-reduced", family="rwkv6", num_layers=2, d_model=32,
    num_heads=0, num_kv_heads=0, d_ff=64, vocab_size=128,
    rwkv_head_size=16, param_dtype="float32",
)

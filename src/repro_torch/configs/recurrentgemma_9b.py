"""RecurrentGemma-9B — RG-LRU + local attention, 1:2 [arXiv:2402.19427]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid_rglru", num_layers=38,
    d_model=4096, num_heads=16, num_kv_heads=1, d_ff=12288,
    vocab_size=256000, head_dim=256,
    block_pattern=("rglru", "rglru", "local"), local_window=2048,
    rglru_dim=4096, rope_theta=10_000.0,
)

REDUCED = ModelConfig(
    name="recurrentgemma-9b-reduced", family="hybrid_rglru", num_layers=5,
    d_model=64, num_heads=4, num_kv_heads=1, d_ff=128, vocab_size=128,
    head_dim=16, block_pattern=("rglru", "rglru", "local"), local_window=16,
    rglru_dim=64, param_dtype="float32",
)

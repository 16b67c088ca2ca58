"""MusicGen-Large — decoder-only over EnCodec tokens, 4 codebooks
[arXiv:2306.05284; hf].  Stub audio frontend per assignment (precomputed
frame embeddings / codebook token streams)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio", num_layers=48, d_model=2048,
    num_heads=32, num_kv_heads=32, d_ff=8192, vocab_size=2048,
    head_dim=64, num_codebooks=4, frontend="audio", rope_theta=10_000.0,
)

REDUCED = ModelConfig(
    name="musicgen-large-reduced", family="audio", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=64, head_dim=16,
    num_codebooks=4, param_dtype="float32",
)

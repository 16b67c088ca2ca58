"""Model zoo of the port: the GQA transformer (dense, MoE, VLM and audio
families), the RWKV-6 family and the RG-LRU hybrid (RecurrentGemma)."""

from typing import Any

from repro_torch.models import rglru, rwkv6, transformer
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.models.rglru import HybridState, RecurrentGemmaLM
from repro_torch.models.rwkv6 import RecurrentState, RWKV6LM
from repro_torch.models.transformer import PagedKVState, TransformerLM


def build_model(cfg: ModelConfig, **kwargs: Any
                ) -> TransformerLM | RWKV6LM | RecurrentGemmaLM:
    """Factory: the family's LM (``device=None`` means the card)."""
    if cfg.family in transformer.FAMILIES:
        return TransformerLM(cfg, **kwargs)
    if cfg.family == "rwkv6":
        return RWKV6LM(cfg, **kwargs)
    if cfg.family == "hybrid_rglru":
        return RecurrentGemmaLM(cfg, **kwargs)
    raise ValueError(f"unknown family {cfg.family}")


def params_from_jax(np_params: dict, cfg: ModelConfig, device) -> dict:
    """Bridge: the JAX package's ``init`` pytree of ``cfg``'s family (as
    numpy arrays) to the port's parameters on ``device``."""
    if cfg.family == "rwkv6":
        return rwkv6.params_from_jax(np_params, cfg, device)
    if cfg.family == "hybrid_rglru":
        return rglru.params_from_jax(np_params, cfg, device)
    return transformer.params_from_jax(np_params, cfg, device)


__all__ = [
    "SHAPES",
    "HybridState",
    "ModelConfig",
    "PagedKVState",
    "RWKV6LM",
    "RecurrentGemmaLM",
    "RecurrentState",
    "ShapeConfig",
    "TransformerLM",
    "build_model",
    "params_from_jax",
]

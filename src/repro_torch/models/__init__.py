"""Model zoo of the port: the GQA transformer (dense, MoE, VLM and audio
families) and the RWKV-6 family (a later slice adds the RG-LRU
family)."""

from typing import Any

from repro_torch.models import rwkv6, transformer
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.models.rwkv6 import RecurrentState, RWKV6LM
from repro_torch.models.transformer import PagedKVState, TransformerLM

#: the slice of the port that brings each family not ported yet
_LATER = {
    "hybrid_rglru": "the RG-LRU slice",
}


def build_model(cfg: ModelConfig, **kwargs: Any) -> TransformerLM | RWKV6LM:
    """Factory: the family's LM (``device=None`` means the card)."""
    if cfg.family in transformer.FAMILIES:
        return TransformerLM(cfg, **kwargs)
    if cfg.family == "rwkv6":
        return RWKV6LM(cfg, **kwargs)
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; it comes "
            f"with {_LATER[cfg.family]} of the PyTorch port (ROADMAP.md)")
    raise ValueError(f"unknown family {cfg.family}")


def params_from_jax(np_params: dict, cfg: ModelConfig, device) -> dict:
    """Bridge: the JAX package's ``init`` pytree of ``cfg``'s family (as
    numpy arrays) to the port's parameters on ``device``."""
    if cfg.family == "rwkv6":
        return rwkv6.params_from_jax(np_params, cfg, device)
    return transformer.params_from_jax(np_params, cfg, device)


__all__ = [
    "SHAPES",
    "ModelConfig",
    "PagedKVState",
    "RWKV6LM",
    "RecurrentState",
    "ShapeConfig",
    "TransformerLM",
    "build_model",
    "params_from_jax",
]

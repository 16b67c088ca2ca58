"""Model zoo of the port: the dense GQA transformer (later slices add the
MoE, VLM, audio, RG-LRU and RWKV-6 families)."""

from typing import Any

from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.models.transformer import (
    PagedKVState,
    TransformerLM,
    params_from_jax,
)

#: the slice of the port that brings each family not ported yet
_LATER = {
    "moe": "the MoE slice",
    "vlm": "the VLM slice",
    "audio": "the audio slice",
    "hybrid_rglru": "the RG-LRU slice",
    "rwkv6": "the RWKV-6 slice (wkv6 kernels)",
}


def build_model(cfg: ModelConfig, **kwargs: Any) -> TransformerLM:
    """Factory: the dense family's LM (``device=None`` means the card)."""
    if cfg.family == "dense":
        return TransformerLM(cfg, **kwargs)
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; it comes "
            f"with {_LATER[cfg.family]} of the PyTorch port (ROADMAP.md)")
    raise ValueError(f"unknown family {cfg.family}")


__all__ = [
    "SHAPES",
    "ModelConfig",
    "PagedKVState",
    "ShapeConfig",
    "TransformerLM",
    "build_model",
    "params_from_jax",
]

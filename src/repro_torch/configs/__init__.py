"""Assigned-architecture registry: ``get_config(arch_id)`` / ``--arch``."""

from repro_torch.configs import (
    deepseek_67b,
    granite_8b,
    granite_moe_1b,
    llama4_maverick,
    musicgen_large,
    qwen2_72b,
    qwen2_7b,
    qwen2_vl_7b,
    recurrentgemma_9b,
    rwkv6_7b,
)
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig

_MODULES = {
    "qwen2-72b": qwen2_72b,
    "qwen2-7b": qwen2_7b,
    "granite-8b": granite_8b,
    "deepseek-67b": deepseek_67b,
    "granite-moe-1b-a400m": granite_moe_1b,
    "llama4-maverick-400b-a17b": llama4_maverick,
    "recurrentgemma-9b": recurrentgemma_9b,
    "qwen2-vl-7b": qwen2_vl_7b,
    "rwkv6-7b": rwkv6_7b,
    "musicgen-large": musicgen_large,
}

ARCHS = tuple(_MODULES)


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    mod = _MODULES[arch]
    return mod.REDUCED if reduced else mod.CONFIG


def get_shape(shape: str) -> ShapeConfig:
    return SHAPES[shape]

"""AdamW, its schedule and clipping, and int8 gradient compression, in
PyTorch (port of ``src/repro/optim``), as plain functions over the port's
parameter trees: nested dicts and lists of tensors."""

from repro_torch.optim.adamw import (
    AdamWConfig, AdamWState, adamw_init, adamw_update, clip_by_global_norm,
    cosine_schedule, global_norm, tree_leaves, tree_map, tree_unflatten,
)

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "cosine_schedule", "global_norm",
           "tree_leaves", "tree_map", "tree_unflatten"]

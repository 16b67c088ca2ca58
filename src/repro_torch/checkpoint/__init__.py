"""Atomic checkpointing with async save (port of ``src/repro/checkpoint``)."""
from repro_torch.checkpoint.checkpoint import (
    AsyncCheckpointer, garbage_collect, latest_step, leaf_paths, restore,
    save,
)
__all__ = ["AsyncCheckpointer", "garbage_collect", "latest_step",
           "leaf_paths", "restore", "save"]

"""Deterministic synthetic data pipeline (port of ``src/repro/data``)."""
from repro_torch.data.pipeline import (DataConfig, SyntheticLMStream,
                                       host_index_count, make_global_batch)
__all__ = ["DataConfig", "SyntheticLMStream", "host_index_count",
           "make_global_batch"]

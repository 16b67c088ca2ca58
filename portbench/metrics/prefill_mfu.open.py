"""Model FLOPs of every token computed in the engine steps that carried a
prefill or continuation, over those steps' summed host wall times the bf16
peak, in %.  Layer: serve/executor.py -> models/transformer.py (prefill,
prefill_continue)."""
from portbench.lib.roofline import mfu_pct


def read(rec):
    return mfu_pct(rec, ("prefill",))

"""Model FLOPs of the engine steps that ran no prefill or continuation,
over their summed host wall times the bf16 peak, in %.  Layer:
serve/executor.py -> models/transformer.py (decode)."""
from portbench.lib.roofline import mfu_pct


def read(rec):
    return mfu_pct(rec, ("decode",))

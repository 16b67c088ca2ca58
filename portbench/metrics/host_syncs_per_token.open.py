"""Host syncs a decoded token over the window (``PerfCounters`` deltas:
``host_syncs / decode_tokens``): how well the fused decode horizon keeps
the host off the per-token path.  Layer: serve/engine.py ->
serve/scheduler.py."""
from portbench.lib.roofline import ratio


def read(rec):
    return ratio(rec, "host_syncs", "decode_tokens")

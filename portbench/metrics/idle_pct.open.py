"""Share of the traced slice in which no operation ran on the device (the
union of all device intervals, overlapping kernels counted once)."""
from portbench.lib.roofline import idle_pct


def read(rec):
    return idle_pct(rec)

"""``paged_decode_attention``'s share of its roofline over the traced slice
(``work/paged_decode_attention.py``), in %."""
from portbench.lib.roofline import kernel_pct


def read(rec):
    return kernel_pct(rec, "paged_decode_attention")

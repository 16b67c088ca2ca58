"""Share of the prompt tokens admitted in the window whose prefill the
radix prefix cache skipped: ``prefill_tokens_skipped / (skipped +
prefill_tokens + continuation_prefill_tokens)``.  Layer:
serve/prefix_cache.py."""


def read(rec):
    c = rec["counters"]
    skipped = c.get("prefill_tokens_skipped", 0)
    total = (skipped + c.get("prefill_tokens", 0)
             + c.get("continuation_prefill_tokens", 0))
    return 100.0 * skipped / total if total else None

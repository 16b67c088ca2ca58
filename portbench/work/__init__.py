"""Work counts from shapes and token counts: what the algorithm needs,
never what an implementation does (no padding, no re-reads)."""

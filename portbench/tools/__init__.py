"""Chip-side tools that set the benchmark's numbers: the knee sweep of an
open-loop cell, the control readings behind each limit, and the spread of
a set of runs.  The benchmark's own runs call none of them."""

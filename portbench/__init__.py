"""The port's benchmark: one cell of ``BENCHMARK.json`` run once.

``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout.  Everything a cell needs is
found by name: ``configs/<config>.json``, ``traffic/<mix>.json`` (its
generator ``traffic/<kind>.py``), ``metrics/<metric>.py`` and
``work/<family>.py``; ``reference/`` holds the plain PyTorch reference.
"""

"""The benchmark of bnpc_tpu_torch: one command, ``python3 portbench/run.py``.

Everything that belongs to one configuration, traffic mix, cell or metric is
a file of its own, found by its name in BENCHMARK.json (see README.md).
"""

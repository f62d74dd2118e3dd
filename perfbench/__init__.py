"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line. Everything a cell is made of is found by name:
``configs/<config>.json``, ``traffic/<traffic>.json``, the traffic's kind
``kinds/<kind>.py``, the configuration's model family
``families/<family>.py`` (its model FLOPs), ``limits/<cell>.json`` and
one reader ``metrics/<metric>.py`` per per-layer metric. ``reference/``
is the plain fp32 PyTorch the outputs are judged against; ``work/`` holds
the frozen operation and byte formulas of the port's kernels.
"""

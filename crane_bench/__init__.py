"""The benchmark of ``crane_tpu_torch``, the PyTorch and CUDA port of crane.

One command runs one cell (a model configuration under a traffic mix) once
on the card and prints one JSON line::

    python -m crane_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives it
(``crane_bench/README.md``). The yardstick (traffic generation, the
percentile and roofline arithmetic, the peaks, the plain float32 references
and the comparison that decides ``correct``) lives here and imports nothing
of the program but what it measures.
"""

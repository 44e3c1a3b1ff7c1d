"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.  Everything
that fixes a measurement lives here, apart from the program: the traffic
generator, the FLOP and byte counts, the table of peaks, the trace
arithmetic, the plain float32 reference and the comparison that decides
``correct``.  Configurations, traffic mixes, limits and per-layer metric
readers are files of their own, found by the names in ``BENCHMARK.json``.
"""

"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA H100.

``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once.  Everything the harness knows of
a configuration, a traffic mix, a cell's limits or a per-layer metric is a
file of its own under ``bench/``, found by the name in ``BENCHMARK.json``.
"""

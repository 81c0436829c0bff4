"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``perfbench/run.py`` runs one cell of ``BENCHMARK.json`` once; see
``harness/cli.py``.  Configurations, traffic mixes, drivers and metric
readers are files found by name (``harness/spec.py``).
"""

"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once; ``control.py``
reads the correctness check's numbers over many seeds for the program
and for its control.  Configurations, traffic mixes and per-layer
metrics are files found by name (``cells.py``); the plain reference and
the frozen generators are in ``reference/``.  Nothing here imports JAX
or the JAX package.
"""

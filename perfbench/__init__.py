"""The benchmark of the PyTorch/CUDA port (``repro_torch``): run a cell
with ``python3 perfbench/run.py``; the cells, metrics and bounds are in
``BENCHMARK.json`` at the repository's root."""

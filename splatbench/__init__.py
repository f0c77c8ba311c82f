"""splatbench: the benchmark of websplat_tpu_torch, the PyTorch and CUDA port.

One run renders one cell (a scene configuration under a traffic mix) for a
fixed window and prints one JSON line; ``python3 -m splatbench.run --help``.
Everything that belongs to one configuration, traffic mix, layer or
per-layer metric is a file of its own under this folder, found by the name
``BENCHMARK.json`` gives it.
"""

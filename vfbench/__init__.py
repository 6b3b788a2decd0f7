"""The benchmark of tpuvf_torch, the port of tpuvf to PyTorch and CUDA.

Run one cell once from the root of a checkout::

    python3 -m vfbench.run --workload cf4k-batch --seed 7 --seconds 20 --trace 0

The cells, configurations, traffic mixes and per-layer metrics are named in
``BENCHMARK.json``; each is a file of its own under ``vfbench/``
(``configs/``, ``traffic/``, ``metrics/``), found by that name.
"""

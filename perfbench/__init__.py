"""The benchmark of ``crdt_benches_tpu_torch`` on NVIDIA GPUs.

``python3 -m perfbench --workload <cell> --seed <n> --seconds <s> --trace 0|1``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.  See
``perfbench/README.md``.
"""

"""Benchmark of the PyTorch/CUDA port (``lzma_sdk_zliblike_tpu_torch``).

``python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on one card and prints
one JSON result line.  See ``port_bench/README.md``.
"""

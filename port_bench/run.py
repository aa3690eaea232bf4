"""The benchmark's one command:

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout that holds the port.  Exits 2, printing no
result, without as many CUDA devices as the cell asks for.
"""

import time

T0 = time.perf_counter()

if __name__ == "__main__":
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[0] = root      # the checkout's root, not this folder
    # Kernel caches at fixed paths inside the checkout (the port builds its
    # CUDA sources into build/torch_kernels there by itself).
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(root, "build", "port_bench", sub)
    from port_bench import bench
    sys.exit(bench.main(t0=T0))

#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, from the root of the checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints one JSON line last on standard output (``portbench.harness``).
Exits 2 without a result when CUDA or enough cards are missing, and 3 when
the run loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, not this folder, heads the path: the program and
# ``portbench`` import as packages from there
sys.path[0] = ROOT
# the toolchains' caches stay at fixed places inside the checkout
for var, sub in (("CUDA_CACHE_PATH", "nv"), ("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(var, os.path.join(ROOT, "build", "portbench", sub))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))

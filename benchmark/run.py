"""Run one cell of the benchmark and print its result line:

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  It needs as many CUDA devices as the cell
asks for, and exits 2 without them."""

import os
import sys
import time

T0 = time.perf_counter()  # the process's start, as near as Python gets

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Caches of the libraries the program uses, at fixed paths in the
# checkout (the program builds its own kernels into raytpu_torch/build/).
CACHE = os.path.join(ROOT, ".bench_cache")
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ[var] = os.path.join(CACHE, sub)
# NCCL's shared-memory transport would write to /dev/shm; the ranks of
# one host talk over NVLink.
os.environ["NCCL_SHM_DISABLE"] = "1"
sys.path.insert(0, ROOT)

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))

"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (`gpnerf_tpu_torch`). It
needs the CUDA devices the cell asks for, and exits non-zero with no result
line without them. See benchmark/harness.py."""

import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# the kernel caches of PyTorch's C++ extensions and of Triton at fixed
# paths inside the checkout, for kernels a later version of the port may
# build that way (the port's nvcc libraries go to gpnerf_tpu_torch/_build/)
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "benchmark", ".cache", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "benchmark", ".cache", "triton")

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], t0=T0))

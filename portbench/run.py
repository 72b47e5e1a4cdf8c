"""Run one cell of the benchmark and print its result as the last line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell, its configuration and its
traffic mix are found by name through `BENCHMARK.json`; see
`portbench/harness.py` for what a run does and prints.
"""

import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "portbench", ".cache")
# Caches at fixed paths inside the checkout (the program's kernel builds
# already land in vsc22_tpu_torch/_build/); a few host threads; no JAX
# through a library that would load it on its own.
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "4"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))

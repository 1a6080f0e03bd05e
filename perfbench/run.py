"""Run one benchmark cell once and print its result line.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Run it from the root of a checkout; the cell's names are in BENCHMARK.json.
It needs a CUDA card and exits with a non-zero code, printing no result,
without one.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT  # import ``perfbench`` as a package, not its files
# The bytecode of every module the run imports, torch's too, is cached at a
# fixed path inside the checkout, whatever the environment says of writing
# it: only a cell's first run compiles it, and later runs load it.
sys.pycache_prefix = os.path.join(ROOT, "build", "perfbench", "pycache")
sys.dont_write_bytecode = False
# Kernel build caches stay at fixed paths inside the checkout.
os.environ.setdefault("TRITON_CACHE_DIR",
                      os.path.join(ROOT, "build", "perfbench", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(ROOT, "build", "perfbench", "extensions"))

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], root=ROOT, t_start=T_START))

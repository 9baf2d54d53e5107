"""Run one benchmark cell once and print its result as the last line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port.  See ``harness.py``.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here, before torch loads

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root, not this directory, heads the import path
sys.path[0] = str(ROOT)
# every cache a build or a JIT could write stays inside the checkout, at a
# fixed path, so that only a cell's first run there builds
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t0=T0))

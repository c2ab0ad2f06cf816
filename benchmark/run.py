#!/usr/bin/env python3
"""One run of one benchmark cell; prints the result as its last line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the CUDA devices the cell
asks for; without them it prints no result and exits with code 2.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path[0] = str(ROOT)
else:
    sys.path.insert(0, str(ROOT))
# every build and kernel cache inside the checkout, at fixed paths; the
# bytecode too, so a run need not compile the modules of a read-only
# installation again
CACHE = ROOT / "build" / "bench_cache"
sys.pycache_prefix = str(CACHE / "pycache")
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("CUDA_CACHE_PATH", str(CACHE / "cuda"))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))

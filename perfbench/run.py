"""Benchmark entry point: ``python3 perfbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``, run from the root of a checkout.

Set-up is timed from the start of this process. The kernels' build cache
stays in the checkout (``build/kernels``, the port's own place), and so do
any other compiler caches, at fixed paths, so that only a checkout's first
run compiles.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    from perfbench import harness
    return harness.main(sys.argv[1:], ROOT, T_START)


if __name__ == "__main__":
    sys.exit(main())

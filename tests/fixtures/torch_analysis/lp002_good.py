# analysis-virtual-path: gserve/timing.py
"""LP002 good: monotonic clock for intervals."""
import time


def measure(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0

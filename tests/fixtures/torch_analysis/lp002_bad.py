# analysis-virtual-path: gserve/timing.py
"""LP002 bad: wall-clock intervals, including both aliased forms the old
grep (`grep -F 'time.time()'`) could never catch."""
import time as t
from time import time as now


def measure(fn):
    t0 = now()  # FLAG: LP002
    fn()
    t1 = t.time()  # FLAG: LP002
    return t1 - t0

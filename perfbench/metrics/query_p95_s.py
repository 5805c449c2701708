"""query_p95_s: 95th percentile of submit-to-host seconds over every query
completed in the window (host clock; numpy's linear interpolation)."""
import numpy as np

from perfbench.readers import serving


def read(run):
    if not serving(run) or not run.latencies:
        return None
    return float(np.percentile(np.asarray(run.latencies, np.float64), 95))

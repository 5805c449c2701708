"""queries_per_s: queries completed in the window over its seconds (host
clock)."""
from perfbench.readers import serving


def read(run):
    if not serving(run) or not run.latencies:
        return None
    return len(run.latencies) / run.seconds

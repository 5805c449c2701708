"""host_reads_per_batch.serve: mean device-to-host reads that decide the
superstep loop's and the local sweeps' ends, a dispatched micro-batch,
over the window: the recorder's ``engine.host_reads`` over
``engine.dispatches`` (traced run)."""
from perfbench.readers import serving


def read(run):
    c = run.counters
    if (not serving(run) or not c.get("engine.dispatches")
            or "engine.host_reads" not in c):
        return None
    return c["engine.host_reads"] / c["engine.dispatches"]

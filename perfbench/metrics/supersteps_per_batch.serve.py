"""supersteps_per_batch.serve: mean supersteps of a dispatched micro-batch
over the traced window: the recorder's ``engine.supersteps`` (summed at
each ``engine.result``) over ``engine.dispatches``."""
from perfbench.readers import serving


def read(run):
    c = run.counters
    if not serving(run) or not c.get("engine.dispatches"):
        return None
    return c.get("engine.supersteps", 0) / c["engine.dispatches"]

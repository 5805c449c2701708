"""lanes_per_batch.serve: mean real lanes of a dispatched micro-batch over
the window (the server's ``ServeMetrics``: deduped sources dispatched over
batches)."""
from perfbench.readers import serving


def read(run):
    s = run.serve
    if not serving(run) or not s.get("batches"):
        return None
    return s["lanes_used"] / s["batches"]

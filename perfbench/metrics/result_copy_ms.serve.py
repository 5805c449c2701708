"""result_copy_ms.serve: mean milliseconds of a micro-batch's host copies
of its result (state, supersteps, local iterations) over the window: the
recorder's span ``serve.copy``, ``span.serve.copy.s`` over
``span.serve.copy.n`` (traced run)."""
from perfbench.readers import serving


def read(run):
    c = run.counters
    if not serving(run) or not c.get("span.serve.copy.n"):
        return None
    return 1e3 * c["span.serve.copy.s"] / c["span.serve.copy.n"]

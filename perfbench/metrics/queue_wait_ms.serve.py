"""queue_wait_ms.serve: mean milliseconds from submit to dispatch of a
dispatched query over the window: the recorder's ``serve.queue_s`` over
``serve.queued`` (``GraphServer``, traced run)."""
from perfbench.readers import serving


def read(run):
    c = run.counters
    if not serving(run) or not c.get("serve.queued"):
        return None
    return 1e3 * c["serve.queue_s"] / c["serve.queued"]

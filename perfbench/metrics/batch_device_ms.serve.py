"""batch_device_ms.serve: mean device milliseconds of a micro-batch over the
window: the server's ``ServeMetrics.device_time_s`` over its executes,
each from the dispatch's first launch to its result on the host
(``PendingResult.device_s``, CUDA events, plus the host copy)."""
from perfbench.readers import serving


def read(run):
    s = run.serve
    if not serving(run) or not s.get("executes"):
        return None
    return 1e3 * s["device_time_s"] / s["executes"]

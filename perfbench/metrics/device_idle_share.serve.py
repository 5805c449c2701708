"""device_idle_share.serve: % of the traced serving window with no
operation on the device (profiler)."""
from perfbench.readers import idle_share, serving


def read(run):
    return idle_share(run) if serving(run) else None

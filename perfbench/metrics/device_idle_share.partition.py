"""device_idle_share.partition: % of the traced partition with no operation
on the device (profiler)."""
from perfbench.readers import idle_share, partitioning


def read(run):
    return idle_share(run) if partitioning(run) else None

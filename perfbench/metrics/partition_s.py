"""partition_s: the window's wall seconds over the whole partitions it
finished (host clock; the window stretches to finish the last one)."""
from perfbench.readers import partitioning


def read(run):
    if not partitioning(run) or not run.partitions:
        return None
    return run.window_s / len(run.partitions)

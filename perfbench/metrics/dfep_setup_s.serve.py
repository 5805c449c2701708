"""dfep_setup_s.serve: wall seconds of the set-up's DFEP partition, ended
by a device synchronise (host clock)."""
from perfbench.readers import serving


def read(run):
    return run.dfep_setup_s if serving(run) else None

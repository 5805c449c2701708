# analysis-virtual-path: core/partition.py
"""LP003 bad: the core layer reaching up into engine/serving — absolute
and relative forms both resolve."""
import repro_torch.engine.runtime  # FLAG: LP003
from repro_torch.gserve import server  # FLAG: LP003
from ..obs import recorder  # FLAG: LP003


def partition(g):
    return repro_torch.engine.runtime, server, recorder, g

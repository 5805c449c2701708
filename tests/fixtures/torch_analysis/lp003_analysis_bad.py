# analysis-virtual-path: analysis/extra.py
"""LP003 bad: the analyzer importing a sibling subsystem, absolutely or
relatively; its own modules stay legal."""
import ast

from repro_torch.kernels import ops  # FLAG: LP003

from ..core import graph  # FLAG: LP003
from . import base
from .base import Rule


def extra():
    return ast, ops, graph, base, Rule

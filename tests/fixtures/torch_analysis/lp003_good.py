# analysis-virtual-path: core/partition.py
"""LP003 good: core depends on core, the kernels and the outside world.
``repro_torch`` is never mistaken for ``repro``."""
import numpy as np
import torch

import repro_torch
from repro_torch.core import dfep

from .. import kernels
from . import graph
from .metrics import evaluate


def partition(g):
    return evaluate(graph.validate(g), np.zeros(1), torch.zeros(1), dfep,
                    kernels, repro_torch)

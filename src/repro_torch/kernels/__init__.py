"""Standalone kernels (PyTorch): the paper's hot spots and the Mamba scan,
the wrappers in ``ops`` and their plain versions in ``ref``."""
from . import ops, ref  # noqa: F401
from .ops import (LAUNCHES, frontier_min, lane_cumsum,  # noqa: F401
                  minplus_sweep, reset_launches, selective_scan)

"""Plain references of what the cells check.

Plain PyTorch and NumPy, independent of the code under test: nothing here
imports ``repro_torch``, the JAX package or anything they made. The inputs
are the cell's graph as host arrays (:class:`EdgeList`), the same arrays the
benchmark hands to the program. ``<program>.py`` answers that served
program's queries (the checker finds it by the program's name);
``dfep.py`` is a frozen copy of DFEP's integer rounds.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class EdgeList(NamedTuple):
    """An undirected graph as the program's padded slot arrays: one slot
    per undirected edge, padding slots masked out."""
    n_vertices: int
    src: np.ndarray    # [E_pad] int
    dst: np.ndarray    # [E_pad] int
    mask: np.ndarray   # [E_pad] bool, True for real edges

    @property
    def n_edges(self) -> int:
        return int(self.mask.sum())

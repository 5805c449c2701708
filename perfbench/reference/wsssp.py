"""Reference of the served ``wsssp`` program: shortest paths over the
content-hash edge weights (:mod:`.weights`), ``inf`` at unreachable
vertices."""
from __future__ import annotations

import numpy as np
import torch

from .relax import shortest_paths
from .weights import edge_weights


def solve(g, sources, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """[S, V] weighted distances from each source."""
    w = edge_weights(np.asarray(g.src), np.asarray(g.dst))
    return shortest_paths(g, sources, w, dtype, device)

"""Reference of the served ``sssp`` program: unit-weight shortest paths,
``inf`` at unreachable vertices."""
from __future__ import annotations

import torch

from .relax import shortest_paths


def solve(g, sources, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """[S, V] hop distances from each source."""
    return shortest_paths(g, sources, None, dtype, device)

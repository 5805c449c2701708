"""Reference of the served ``bfs`` program: hop levels, ``-1`` at
unreachable vertices."""
from __future__ import annotations

import torch

from .relax import shortest_paths


def solve(g, sources, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """[S, V] hop levels from each source."""
    d = shortest_paths(g, sources, None, dtype, device)
    return torch.where(torch.isinf(d), torch.full_like(d, -1.0), d)

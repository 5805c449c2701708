"""Single-source shortest paths by plain Bellman-Ford relaxation.

Every directed half-edge relaxes its head from its tail until nothing
changes, for a block of sources at once: ``dist[v] = min(dist[v],
dist[u] + w)``, each sum rounded to the precision asked for (the values are
held in float32, which holds every bfloat16 exactly). The fixpoint is the
least path sum, each path summed from its source in that precision,
whatever order the relaxations run in, because rounding an addition is
monotone. Answers are float32 on the device they were computed on.
"""
from __future__ import annotations

import numpy as np
import torch

from . import EdgeList


def shortest_paths(g: EdgeList, sources, weights: np.ndarray | None,
                   dtype: torch.dtype, device, block: int = 64
                   ) -> torch.Tensor:
    """[S, V] distances (``inf`` where unreachable) from each source, over
    unit weights (``weights`` None) or per-edge ``weights`` [E_pad]."""
    m = np.asarray(g.mask, bool)
    u = np.asarray(g.src, np.int64)[m]
    v = np.asarray(g.dst, np.int64)[m]
    tail = torch.from_numpy(np.concatenate([u, v])).to(device)
    head = torch.from_numpy(np.concatenate([v, u])).to(device)
    if weights is None:
        w = torch.ones(tail.shape[0], device=device)
    else:
        w1 = torch.from_numpy(np.asarray(weights, np.float32)[m])
        w = torch.cat([w1, w1]).to(device).to(dtype).float()
    sources = torch.as_tensor(np.asarray(sources, np.int64), device=device)
    out = []
    for lo in range(0, int(sources.shape[0]), block):
        src = sources[lo:lo + block]
        n = int(src.shape[0])
        dist = torch.full((g.n_vertices, n), float("inf"), device=device)
        dist[src, torch.arange(n, device=device)] = 0
        head_n = head[:, None].expand(-1, n)
        while True:
            cand = (dist[tail] + w[:, None]).to(dtype).float()  # [2E, n]
            new = dist.scatter_reduce(0, head_n, cand, "amin")
            if torch.equal(new, dist):
                break
            dist = new
        out.append(dist.t())
    return torch.cat(out).contiguous()

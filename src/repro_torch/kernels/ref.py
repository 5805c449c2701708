"""Plain PyTorch versions of the kernels in ``ops`` (the counterparts of
``repro.kernels.ref``'s oracles). The CPU path of every wrapper runs these;
the tests hold them against the JAX package and ``chip_smoke.py`` holds
the CUDA kernels against them on the card."""
from __future__ import annotations

import math

import torch


def cumsum_lanes(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along axis 0 of an [S, K] array, in its own dtype
    (``torch.cumsum`` would widen int32 to int64).

    Plain version of ``lane_cumsum`` — DFEP's step-1 rank cumsum.
    """
    return torch.cumsum(x, 0, dtype=x.dtype)


def kreduce_min(state: torch.Tensor, member: torch.Tensor) -> torch.Tensor:
    """Masked min over axis 0: [K, V] x [K, V] bool -> [V], ``+inf`` where
    no row is a member.

    Plain version of ``frontier_min`` — the ETSCH aggregation phase.
    """
    return torch.where(member, state, math.inf).amin(dim=0)


def minplus_relax(dist: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                  mask: torch.Tensor, cost: float = 1.0) -> torch.Tensor:
    """One undirected min-plus relaxation sweep: for each edge (u, v) with
    ``mask``, out[v] = min(out[v], dist[u]+cost) and out[u] =
    min(out[u], dist[v]+cost). Both candidates come from the input ``dist``
    (Jacobi).

    Plain version of ``minplus_sweep`` — the ETSCH local-computation phase.
    dist [V] float; src/dst [E] int; mask [E] bool.
    """
    s, d = src.long(), dst.long()
    cu = torch.where(mask, dist[s] + cost, math.inf)
    cv = torch.where(mask, dist[d] + cost, math.inf)
    out = dist.clone()
    out.scatter_reduce_(0, d, cu, "amin")
    out.scatter_reduce_(0, s, cv, "amin")
    return out

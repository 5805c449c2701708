"""Distributed ETSCH over a ``torch.distributed`` process group: partitions
→ ranks, frontier aggregation → collective.

Counterpart of ``repro.core.etsch_distributed``, the paper's Fig.-2
deployment: each rank holds ``K/ndev`` edge partitions (rows ``[rank·k_loc,
(rank+1)·k_loc)`` of the :class:`Partitioning`, padded with empty
partitions to a multiple of the world size), runs the local phase on them
alone, and the aggregation is one ``all_reduce`` (min or sum) across the
ranks: the only communication, sized by V.

The local phase is ``etsch.min_relax_sweep`` (the ``minplus_sweep`` kernel)
on the rank's partitions to their local fixed point; SSSP's aggregation is
``kernels.ops.frontier_min`` over the member mask, then a min across the
ranks. Every rank calls with the same arguments and returns the same
result. The loops read the device once a local sweep and once a superstep.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from . import collectives as C
from .etsch import Partitioning, min_relax_sweep

INF = float("inf")


def _pad_partitions(part: Partitioning, ndev: int) -> Partitioning:
    """Pad K to a multiple of ndev with empty partitions."""
    k = part.k
    k_pad = -(-k // ndev) * ndev
    if k_pad == k:
        return part
    pad = k_pad - k

    def padk(x, fill=0):
        return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill,
                                        dtype=x.dtype, device=x.device)])

    return Partitioning(k_pad, part.n_vertices, part.e_max,
                        padk(part.src), padk(part.dst), padk(part.mask, False),
                        padk(part.member, False), padk(part.frontier, False))


def _local_rows(part: Partitioning, group) -> Partitioning:
    """This rank's partitions of ``part`` padded to the world size, kept on
    ``part`` per (world, rank), so repeated queries reuse their slice and
    its ``minplus_sweep`` layout."""
    ndev, my = C.world(group), C.rank(group)

    def make():
        full = _pad_partitions(part, ndev)
        k_loc = full.k // ndev
        rows = slice(my * k_loc, (my + 1) * k_loc)
        return Partitioning(k_loc, full.n_vertices, full.e_max,
                            *(getattr(full, f)[rows].contiguous() for f in
                              ("src", "dst", "mask", "member", "frontier")))

    return part._memo(f"_ranks_{ndev}_{my}", make)


def sssp_sharded(part: Partitioning, source: int, group=None,
                 max_supersteps: int = 512) -> tuple[torch.Tensor, int]:
    """Distributed SSSP over an edge partitioning. Returns (dist [V],
    supersteps).

    Local phase: unit-cost min-plus sweeps to the rank's local fixed point.
    Aggregation: the masked min over the rank's partitions, then a min
    across the ranks (frontier reconcile)."""
    loc = _local_rows(part, group)
    member = loc.member
    iota = torch.arange(loc.n_vertices, device=member.device)
    dist = torch.where(member & (iota == int(source))[None, :], 0.0,
                       INF).to(torch.float32)
    steps, changed = 0, True
    while changed and steps < max_supersteps:
        d1, moved = dist, True
        while moved:                                  # local fixed point
            nd = min_relax_sweep(loc, d1)
            moved = bool((nd != d1).any())
            d1 = nd
        agg = C.all_reduce_(ops.frontier_min(d1, member), "min", group)
        d2 = torch.where(member, agg[None, :], INF)
        n_changed = (d2 != dist).sum(dtype=torch.int32).reshape(1)
        changed = int(C.all_reduce_(n_changed, "sum", group)) > 0
        dist, steps = d2, steps + 1
    out = C.all_reduce_(ops.frontier_min(dist, member), "min", group)
    return out, steps


def pagerank_sharded(part: Partitioning, degrees: torch.Tensor, group=None,
                     iters: int = 30, damping: float = 0.85) -> torch.Tensor:
    """Distributed PageRank: each rank's partial in-flows (a scatter-add
    per partition, summed over its partitions), then a sum across the
    ranks. Returns rank [V]."""
    loc = _local_rows(part, group)
    dev = loc.device
    v_n = loc.n_vertices
    deg = torch.as_tensor(degrees, device=dev).to(torch.float32).clamp(min=1.0)
    flat_src, flat_dst = loc.flat_src.long(), loc.flat_dst.long()
    src, dst = loc.src.reshape(-1).long(), loc.dst.reshape(-1).long()
    mask = loc.flat_mask
    rank = torch.full((v_n,), 1.0 / v_n, dtype=torch.float32, device=dev)
    for _ in range(iters):
        c = rank / deg
        cu = torch.where(mask, c[src], 0.0)
        cv = torch.where(mask, c[dst], 0.0)
        part_in = torch.zeros(loc.k * v_n, dtype=torch.float32, device=dev)
        part_in.index_add_(0, flat_dst, cu)
        part_in.index_add_(0, flat_src, cv)
        local = part_in.view(loc.k, v_n).sum(dim=0)
        inflow = C.all_reduce_(local, "sum", group)       # aggregation phase
        rank = (1.0 - damping) / v_n + damping * inflow
    return rank

"""Partition-quality metrics (paper §V-A) in PyTorch: balance/NSTDEV,
communication cost (MESSAGES = Σ|F_i|), connectedness, and the *gain* of
ETSCH SSSP over the vertex-centric baseline.

Counterpart of ``repro.core.metrics``, field for field. The connectedness
test (label propagation inside each partition) and the gain (ETSCH SSSP
against ``reference_sssp``) run through ``kernels.ops.minplus_sweep``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .algorithms import etsch_sssp, reference_sssp
from .etsch import Partitioning, compile_partitioning, min_relax_sweep
from .graph import Graph


@dataclasses.dataclass(frozen=True)
class PartitionMetrics:
    k: int
    sizes: np.ndarray            # [K] edges per partition
    largest_norm: float          # max |E_i| / (|E|/K)     (paper fig 5a/7a)
    nstdev: float                # paper's NSTDEV formula  (fig 5/6f/7)
    messages: int                # Σ|F_i|                  (fig 5c/6c/7c)
    frontier_total: int          # number of distinct frontier vertices
    replication_factor: float    # Σ|V_i| / |V|
    connected_frac: float        # fraction of partitions that are connected
    rounds: int | None = None    # partitioner rounds (when known)
    gain: float | None = None    # ETSCH SSSP gain       (fig 5d/6d/7d)

    def row(self) -> dict:
        d = dataclasses.asdict(self)
        d["sizes"] = None
        return d


def _numpy(a) -> np.ndarray:
    """A host copy of a tensor or array."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.array(a)


def _sizes(owner: np.ndarray, k: int) -> np.ndarray:
    return np.bincount(owner[owner >= 0], minlength=k)


def nstdev(sizes: np.ndarray, n_edges: int) -> float:
    k = len(sizes)
    norm = sizes / (n_edges / k)
    return float(np.sqrt(np.mean((norm - 1.0) ** 2)))


def _membership(g: Graph, owner: torch.Tensor, k: int) -> torch.Tensor:
    """[K, V] bool: v ∈ V_i, from the live edges with an owner in [0, k)."""
    owner = owner.to(g.device)
    valid = g.edge_mask & (owner >= 0)
    row = torch.where(valid, owner, 0).long() * g.n_vertices
    hits = torch.zeros(k * g.n_vertices, dtype=torch.int32, device=g.device)
    for end in (g.src, g.dst):
        hits.index_add_(0, row + end.long(), valid.to(torch.int32))
    return (hits > 0).view(k, g.n_vertices)


def connected_fraction(part: Partitioning) -> float:
    """Fraction of partitions whose induced subgraph is connected (paper fig
    6e plots the complement): min-label propagation inside every partition,
    a cost-0 ``min_relax_sweep`` per step."""
    v_n = part.n_vertices
    ids = torch.arange(v_n, dtype=torch.float32, device=part.device)
    lab = torch.where(part.member, ids[None, :], torch.inf)
    changed = True
    while changed:
        nl = min_relax_sweep(part, lab, edge_cost=0.0)
        changed = bool((nl != lab).any())
        lab = nl
    # connected iff all members share one label
    mn = torch.where(part.member, lab, torch.inf).amin(dim=1, keepdim=True)
    same = torch.where(part.member, lab == mn, True)
    conn = same.all(dim=1)
    nonempty = part.member.any(dim=1)
    # the reference divides int32 counts, which JAX does in float32
    n_conn = int((conn & nonempty).sum())
    return float(np.float32(n_conn) / np.float32(max(int(nonempty.sum()), 1)))


def evaluate(g: Graph, owner, k: int, *, rounds: int | None = None,
             compute_gain: bool = True, part: Partitioning | None = None,
             source: int = 0) -> PartitionMetrics:
    """The paper's partition metrics for ``owner`` [E_pad] (an edge's
    partition, negative where unowned), computed on ``g``'s device."""
    owner_np = _numpy(owner)
    emask = g.edge_mask.cpu().numpy()
    sizes = _sizes(owner_np[emask], k)

    member = _membership(g, torch.from_numpy(owner_np), k).cpu().numpy()
    replicas = member.sum(0)
    frontier_per_part = (member & (replicas[None, :] >= 2)).sum(1)
    messages = int(frontier_per_part.sum())

    if part is None:
        part = compile_partitioning(g, owner_np, k, device=g.device)

    gain = None
    if compute_gain:
        res = etsch_sssp(part, source)
        _, ref_rounds = reference_sssp(g, source)
        gain = float(1.0 - res.supersteps / max(ref_rounds, 1))

    return PartitionMetrics(
        k=k,
        sizes=sizes,
        largest_norm=float(sizes.max() / (g.n_edges / k)),
        nstdev=nstdev(sizes, g.n_edges),
        messages=messages,
        frontier_total=int((replicas >= 2).sum()),
        replication_factor=float(member.sum() / max(g.n_vertices, 1)),
        connected_frac=connected_fraction(part),
        rounds=rounds,
        gain=gain,
    )

"""Concrete ETSCH problems (paper Algorithms 1–2 and the ones it sketches)
and whole-graph vertex-centric references, used both as correctness
oracles and as the paper's baseline for the *gain* metric (PyTorch).

Counterpart of ``repro.core.algorithms``. SSSP, CC, multi-source SSSP and
the vertex-centric ``reference_sssp`` / ``reference_cc`` relax through
``kernels.ops.minplus_sweep`` and aggregate through
``kernels.ops.frontier_min``; PageRank, MIS and k-core aggregate by sum or
max, which no kernel of the paper computes, and stay plain torch as they
are plain jnp in the reference.

The reference's random draws cannot be reproduced in torch: CC's vertex
ids (``jax.random.permutation``) and MIS's priorities
(``jax.random.uniform``) are taken as explicit ``ids=`` / ``prio=``
tensors, or drawn from a ``torch.Generator`` seeded with ``seed``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import ops
from .etsch import (EtschResult, Partitioning, Problem, min_relax_sweep,
                    run_etsch)
from .graph import Graph, edge_weights

INF = math.inf


def _generator(seed: int) -> torch.Generator:
    """A seeded CPU generator: the same draws on every device."""
    return torch.Generator().manual_seed(int(seed))


def _tensor(a) -> torch.Tensor:
    """A tensor as it is, anything else (numpy, a JAX array) copied."""
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))


def _min_reduce(part: Partitioning, st: torch.Tensor) -> torch.Tensor:
    return ops.frontier_min(st, part.member)


# ---------------------------------------------------------------------------
# Algorithm 1: single-source shortest paths (unit weights)
# ---------------------------------------------------------------------------

def _sssp_init(part: Partitioning, *, source: int) -> torch.Tensor:
    src_col = torch.arange(part.n_vertices, device=part.device) == source
    return torch.where(part.member & src_col[None, :], 0.0, INF)


SSSP = Problem(
    init=_sssp_init,
    local_sweep=min_relax_sweep,
    reduce=_min_reduce,
    identity=INF,
    mode="replica",
)


def etsch_sssp(part: Partitioning, source: int) -> EtschResult:
    return run_etsch(part, SSSP, source=int(source))


# ---------------------------------------------------------------------------
# Algorithm 2: connected components (random ids -> epidemic min)
# ---------------------------------------------------------------------------

def _cc_init(part: Partitioning, *, ids: torch.Tensor) -> torch.Tensor:
    ids = ids.to(device=part.device, dtype=torch.float32)
    return torch.where(part.member, ids[None, :], INF)


def _cc_sweep(part: Partitioning, state: torch.Tensor) -> torch.Tensor:
    return min_relax_sweep(part, state, edge_cost=0.0)


CC = Problem(
    init=_cc_init,
    local_sweep=_cc_sweep,
    reduce=_min_reduce,
    identity=INF,
    mode="replica",
)


def etsch_cc(part: Partitioning, ids=None, seed: int = 0) -> EtschResult:
    """``ids`` [V]: a permutation of the vertex ids (the reference draws one
    with ``jax.random.permutation``); without it one is drawn from a
    generator seeded with ``seed``."""
    if ids is None:
        ids = torch.randperm(part.n_vertices, generator=_generator(seed))
    return run_etsch(part, CC, ids=_tensor(ids))


# ---------------------------------------------------------------------------
# PageRank over an edge partitioning (sum-aggregation; paper §III sketch)
# ---------------------------------------------------------------------------

class PageRankResult(NamedTuple):
    rank: torch.Tensor
    supersteps: int


def _scatter_rows(part: Partitioning, pairs, fill=0.0, reduce: str = "sum",
                  dtype=torch.float32) -> torch.Tensor:
    """[K, V] filled with ``fill``; each (idx [K, E], vals [K, E]) of
    ``pairs`` combined in at (k, idx[k, e]) by ``reduce`` ("sum", "amin"
    or "amax"), in order, as the reference's chained ``.at[rows, idx]``
    updates."""
    k, v_n = part.k, part.n_vertices
    out = torch.full((k * v_n,), fill, dtype=dtype, device=part.device)
    base = torch.arange(k, device=part.device)[:, None] * v_n
    for idx, vals in pairs:
        flat, vals = (base + idx.long()).reshape(-1), vals.reshape(-1)
        if reduce == "sum":
            out.index_add_(0, flat, vals)
        else:
            out.scatter_reduce_(0, flat, vals, reduce)
    return out.view(k, v_n)


def etsch_pagerank(part: Partitioning, degrees: torch.Tensor, iters: int = 30,
                   damping: float = 0.85) -> PageRankResult:
    """Each superstep: partitions compute *partial* in-flows over their own
    edges; frontier aggregation sums the partials (each edge lives in exactly
    one partition, so the sum is exact)."""
    v_n = part.n_vertices
    dev = part.device
    rank = torch.full((v_n,), 1.0 / v_n, dtype=torch.float32, device=dev)
    deg = degrees.to(device=dev, dtype=torch.float32).clamp(min=1.0)
    src, dst = part.src.long(), part.dst.long()
    for _ in range(iters):
        contrib = rank / deg                                       # [V]
        cu = torch.where(part.mask, contrib[src], 0.0)             # [K, E]
        cv = torch.where(part.mask, contrib[dst], 0.0)
        partial = _scatter_rows(part, ((part.dst, cu),             # u -> v
                                       (part.src, cv)))            # v -> u
        inflow = partial.sum(dim=0)                         # aggregation
        rank = (1.0 - damping) / v_n + damping * inflow
    return PageRankResult(rank, int(iters))


# ---------------------------------------------------------------------------
# Luby maximal independent set (paper §III: "also possible in ETSCH")
# ---------------------------------------------------------------------------

class MisResult(NamedTuple):
    in_set: torch.Tensor    # [V] bool
    supersteps: int


def etsch_mis(part: Partitioning, prio=None, seed: int = 0,
              max_supersteps: int = 256) -> MisResult:
    """Luby's algorithm: local phase spreads random priorities along
    partition edges; aggregation takes the min over replicas; vertices that
    beat every undecided neighbour join the set, their neighbours drop out.

    ``prio`` [V] float32 in [1e-6, 1) (the reference draws it with
    ``jax.random.uniform``); without it it is drawn from a generator seeded
    with ``seed``."""
    v_n = part.n_vertices
    dev = part.device
    if prio is None:
        prio = 1e-6 + (1.0 - 1e-6) * torch.rand(
            v_n, generator=_generator(seed))
    prio = _tensor(prio).to(device=dev, dtype=torch.float32)
    # status: 0 undecided / 1 in set / 2 excluded
    status = torch.zeros(v_n, dtype=torch.int32, device=dev)
    src, dst = part.src.long(), part.dst.long()
    steps, changed = 0, True
    while changed and steps < max_supersteps:
        undecided = status == 0
        p = torch.where(undecided, prio, INF)                      # [V]
        # local phase: min undecided-neighbour priority over partition edges
        pu = torch.where(part.mask, p[src], INF)
        pv = torch.where(part.mask, p[dst], INF)
        mn = _scatter_rows(part, ((part.dst, pu), (part.src, pv)), INF,
                           "amin")
        min_nbr = mn.amin(dim=0)                            # aggregation
        join = undecided & (p < min_nbr)
        # second half-superstep: neighbours of joiners are excluded
        j = join.to(torch.float32)
        ex = _scatter_rows(part, (
            (part.dst, torch.where(part.mask, j[src], 0.0)),
            (part.src, torch.where(part.mask, j[dst], 0.0))), 0.0, "amax")
        excluded = ex.amax(dim=0) > 0                       # aggregation
        new_status = torch.where(join, 1, status)
        new_status = torch.where(excluded & (new_status == 0), 2, new_status)
        changed = bool((new_status != status).any())
        status, steps = new_status.to(torch.int32), steps + 1
    return MisResult(status == 1, steps)


# ---------------------------------------------------------------------------
# Whole-graph vertex-centric references (correctness oracles + gain baseline)
# ---------------------------------------------------------------------------

def _graph_layout(g: Graph) -> ops.MinplusLayout:
    """``minplus_sweep``'s layout of the whole graph, built once per
    :class:`Graph` (which is immutable)."""
    lay = g.__dict__.get("_minplus_layout")
    if lay is None:
        lay = ops.minplus_layout(g.src, g.dst, g.n_vertices)
        object.__setattr__(g, "_minplus_layout", lay)
    return lay


def _vertex_centric(g: Graph, d: torch.Tensor, cost: float):
    """Sweeps of ``minplus_sweep`` over the whole graph until nothing
    changes, at most ``n_vertices`` rounds. Returns (values, rounds)."""
    r, changed, lay = 0, True, _graph_layout(g)
    while changed and r < g.n_vertices:
        nd = ops.minplus_sweep(d, g.src, g.dst, g.edge_mask, cost,
                               layout=lay)
        changed = bool((nd != d).any())
        d, r = nd, r + 1
    return d, r


def reference_sssp(g: Graph, source: int) -> tuple[torch.Tensor, int]:
    """Pregel-style BFS: one relaxation hop per round. Returns (dist,
    rounds). ``rounds`` is the vertex-centric superstep count the paper's
    *gain* compares against."""
    dist0 = torch.full((g.n_vertices,), INF, dtype=torch.float32,
                       device=g.device)
    dist0[int(source)] = 0.0
    return _vertex_centric(g, dist0, 1.0)


def reference_cc(g: Graph) -> tuple[torch.Tensor, int]:
    label0 = torch.arange(g.n_vertices, dtype=torch.float32, device=g.device)
    return _vertex_centric(g, label0, 0.0)


def _undirected_add(g: Graph, vals: torch.Tensor) -> torch.Tensor:
    """[V] sum over edges of ``vals`` of the other endpoint, both ways."""
    src, dst = g.src.long(), g.dst.long()
    out = torch.zeros_like(vals)
    out.index_add_(0, dst, torch.where(g.edge_mask, vals[src], 0))
    out.index_add_(0, src, torch.where(g.edge_mask, vals[dst], 0))
    return out


def reference_pagerank(g: Graph, iters: int = 30,
                       damping: float = 0.85) -> torch.Tensor:
    v_n = g.n_vertices
    deg = g.degrees().to(torch.float32).clamp(min=1.0)
    rank = torch.full((v_n,), 1.0 / v_n, dtype=torch.float32, device=g.device)
    for _ in range(iters):
        inflow = _undirected_add(g, rank / deg)
        rank = (1.0 - damping) / v_n + damping * inflow
    return rank


def reference_weighted_sssp(g: Graph, source: int) -> np.ndarray:
    """Weighted shortest paths under the deterministic content-hash weights
    (``graph.edge_weights``), iterated to the relaxation fixpoint.

    Host-side numpy, float32 throughout: each relaxation computes
    ``min(d[v], f32(d[u] + w))``, the same IEEE operation as the engine's
    min-plus sweeps, so the fixpoint is bit-identical to theirs.
    """
    u, v = g.as_numpy()
    w = edge_weights(u, v)
    dist = np.full(g.n_vertices, np.inf, np.float32)
    dist[int(source)] = 0.0
    for _ in range(g.n_vertices):
        nd = dist.copy()
        np.minimum.at(nd, v, (dist[u] + w).astype(np.float32))
        np.minimum.at(nd, u, (dist[v] + w).astype(np.float32))
        if np.array_equal(nd, dist, equal_nan=True):
            break
        dist = nd
    return dist


def reference_label_propagation(g: Graph, labels) -> np.ndarray:
    """Min-label propagation over an *external* label plane ([V] or [V, 1]
    float32): every vertex converges to the smallest label in its connected
    component (an isolated vertex keeps its own). Labels flow through min
    only, so engine results are bit-identical to this oracle."""
    lab = np.asarray(labels, np.float32).reshape(-1)
    u, v = g.as_numpy()
    out = lab.copy()
    for _ in range(g.n_vertices):
        new = out.copy()
        np.minimum.at(new, v, out[u])
        np.minimum.at(new, u, out[v])
        if np.array_equal(new, out):
            break
        out = new
    return out


def reference_personalized_pagerank(g: Graph, personalization,
                                    iters: int = 30,
                                    damping: float = 0.85) -> np.ndarray:
    """Degree-weighted PageRank with an external teleport vector ``p`` ([V]
    or [V, 1]): ``rank <- (1-d) * p + d * inflow``, each vertex spreading
    ``rank/deg`` along its edges, starting from ``p``. Host numpy, float32;
    partition-order reassociation keeps engine results within 1e-5."""
    p = np.asarray(personalization, np.float32).reshape(-1)
    u, v = g.as_numpy()
    deg = np.maximum(np.bincount(np.concatenate([u, v]),
                                 minlength=g.n_vertices), 1).astype(np.float32)
    rank = p
    for _ in range(int(iters)):
        c = rank / deg
        inflow = np.zeros_like(rank)
        np.add.at(inflow, v, c[u])
        np.add.at(inflow, u, c[v])
        rank = ((1.0 - damping) * p + damping * inflow).astype(np.float32)
    return rank


def reference_gcn_layer(g: Graph, x, weight) -> np.ndarray:
    """Dense numpy reference for one GCN layer forward pass over the
    undirected weighted graph: ``out = (D^{-1/2} A_w D^{-1/2} X) W``, with
    the content-hash ``edge_weights``, no self-loops and degrees clamped at
    1. ``x`` [V, F_in], ``weight`` [F_in, F_out]; float32 throughout."""
    x = np.asarray(x, np.float32)
    w = np.asarray(weight, np.float32)
    u, v = g.as_numpy()
    ew = edge_weights(u, v)
    deg = np.bincount(np.concatenate([u, v]), minlength=g.n_vertices)
    inv_sqrt = (1.0 / np.sqrt(np.maximum(deg.astype(np.float32), 1.0))
                ).astype(np.float32)
    xn = x * inv_sqrt[:, None]
    agg = np.zeros_like(x)
    np.add.at(agg, v, xn[u] * ew[:, None])
    np.add.at(agg, u, xn[v] * ew[:, None])
    return ((agg * inv_sqrt[:, None]) @ w).astype(np.float32)


def reference_kge_score(g: Graph, entity, relation) -> np.ndarray:
    """Dense numpy reference for DistMult-style triple scoring summed per
    vertex: each live edge e = (u, v) scores ``sum_f ent_u[f] * r_e[f] *
    ent_v[f]`` onto both endpoints. ``relation`` rows are graph edge slots;
    slots past the supplied rows score 0. Float32."""
    ent = np.asarray(entity, np.float32)
    rel = np.asarray(relation, np.float32)
    slots = np.flatnonzero(g.edge_mask.cpu().numpy())
    u = g.src.cpu().numpy()[slots]
    v = g.dst.cpu().numpy()[slots]
    covered = slots < rel.shape[0]
    r = np.where(covered[:, None], rel[np.minimum(slots, rel.shape[0] - 1)],
                 np.float32(0.0))
    s = np.sum(ent[u] * r * ent[v], axis=1, dtype=np.float32)
    out = np.zeros(g.n_vertices, np.float32)
    np.add.at(out, u, s)
    np.add.at(out, v, s)
    return out


def reference_bfs(g: Graph, source: int) -> np.ndarray:
    """BFS hop levels: 0.0 at the source, the hop count elsewhere, and -1.0
    for vertices unreachable from the source (float32)."""
    d = reference_sssp(g, source)[0].cpu().numpy()
    return np.where(np.isinf(d), np.float32(-1.0), d).astype(np.float32)


def is_independent_set(g: Graph, in_set: torch.Tensor) -> bool:
    src, dst = g.src.long(), g.dst.long()
    both = in_set[src] & in_set[dst] & g.edge_mask
    return not bool(both.any())


def is_maximal_independent_set(g: Graph, in_set: torch.Tensor) -> bool:
    nbr_in = _undirected_add(g, in_set.to(torch.int32)) > 0
    covered = in_set | nbr_in
    deg = g.degrees() > 0
    return is_independent_set(g, in_set) and bool((covered | ~deg).all())


# ---------------------------------------------------------------------------
# Multi-source distances (building block for betweenness centrality) — one
# ETSCH run computes distances from S sources at once (state [K, S, V]).
# ---------------------------------------------------------------------------

class MultiSsspResult(NamedTuple):
    dist: torch.Tensor      # [S, V]
    supersteps: int


def etsch_multi_sssp(part: Partitioning, sources,
                     max_supersteps: int = 512) -> MultiSsspResult:
    """Distances from every source in ``sources`` [S] at once; the frontier
    aggregation reconciles an [S, V] replica block per partition. The local
    sweep is one ``minplus_sweep`` over the flattened [K·S·V] state (the
    partitioning's [K·V] layout with S replicas: row ``k·V + v`` stands for
    ``(k·S + s)·V + v``), the aggregation one ``frontier_min`` over
    [K, S·V]."""
    dev = part.device
    k, v_n = part.k, part.n_vertices
    sources = _tensor(sources).to(dev).long().reshape(-1)
    n_src = int(sources.numel())
    is_src = sources[:, None] == torch.arange(v_n, device=dev)[None, :]
    member = part.member[:, None, :]                            # [K, 1, V]
    d = torch.where(member & is_src[None], 0.0, INF)            # [K, S, V]
    lay = part.minplus_layout.with_replicas(n_src)
    member_sv = member.expand(k, n_src, v_n).reshape(k, n_src * v_n)

    def reduce(st):                                             # [S, V]
        return ops.frontier_min(st.reshape(k, n_src * v_n),
                                member_sv).view(n_src, v_n)

    steps, changed = 0, True
    while changed and steps < max_supersteps:
        d1, moved = d, True
        while moved:                                            # local phase
            nd = ops.minplus_sweep(d1.reshape(-1), part.flat_src,
                                   part.flat_dst, part.flat_mask, 1.0,
                                   layout=lay).view(k, n_src, v_n)
            moved = bool((nd != d1).any())
            d1 = nd
        d2 = torch.where(member, reduce(d1)[None], INF)
        changed = bool((d2 != d).any())
        d, steps = d2, steps + 1
    return MultiSsspResult(reduce(d), steps)


# ---------------------------------------------------------------------------
# k-core decomposition (iterative peeling) on ETSCH: the local phase counts
# partition-local degrees among active vertices; aggregation sums the
# partials (each edge lives in exactly one partition, so the sum is exact).
# ---------------------------------------------------------------------------

class KCoreResult(NamedTuple):
    in_core: torch.Tensor   # [V] bool — member of the k-core
    supersteps: int


def etsch_kcore(part: Partitioning, k_core: int,
                max_supersteps: int = 512) -> KCoreResult:
    v_n = part.n_vertices
    dev = part.device
    src, dst = part.src.long(), part.dst.long()
    touched = torch.zeros(v_n, dtype=torch.int32, device=dev)
    ones = part.mask.to(torch.int32).reshape(-1)
    touched.index_add_(0, src.reshape(-1), ones)
    touched.index_add_(0, dst.reshape(-1), ones)
    active = touched > 0
    steps, changed = 0, True
    while changed and steps < max_supersteps:
        live = (part.mask & active[src] & active[dst]).to(torch.int32)
        partial = _scatter_rows(part, ((part.src, live), (part.dst, live)),
                                0, "sum", torch.int32)
        deg = partial.sum(dim=0, dtype=torch.int32)              # aggregation
        new_active = active & (deg >= k_core)
        changed = bool((new_active != active).any())
        active, steps = new_active, steps + 1
    return KCoreResult(active, steps)


def reference_kcore(g: Graph, k_core: int) -> torch.Tensor:
    active = g.degrees() > 0
    src, dst = g.src.long(), g.dst.long()
    changed = True
    while changed:
        live = (g.edge_mask & active[src] & active[dst]).to(torch.int32)
        deg = torch.zeros(g.n_vertices, dtype=torch.int32, device=g.device)
        deg.index_add_(0, src, live)
        deg.index_add_(0, dst, live)
        new = active & (deg >= k_core)
        changed = bool((new != active).any())
        active = new
    return active

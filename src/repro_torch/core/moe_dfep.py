"""DFEP-balanced MoE expert placement (the counterpart of
``repro/core/moe_dfep.py``).

The token→expert assignment of an MoE layer is a bipartite graph that
changes slowly. Expert-parallel sharding assigns experts to shards; skewed
routing makes some shards' dispatch buffers overflow (token drops) while
others idle — a *balance* failure, exactly the objective DFEP optimises.

Mapping:
  * vertices  = experts;
  * edges     = co-activation events — expert pairs selected together by
    one token (sampled proportionally to their observed frequency, so edge
    *count* encodes weight and DFEP stays unweighted);
  * partitions = shards; DFEP buys co-activation edges with its funding
    auction, producing connected, balanced edge groups;
  * an expert is placed on the shard owning the majority of its incident
    edges (ties → lower shard id), with per-shard capacity E/K enforced by
    bumping overflow experts to the lightest shard.

DFEP runs on ``device`` through the port's ``dfep.partition`` (its rank
cumsums through the ``lane_cumsum`` kernel on the card); the sampling and
the vote are host numpy, as in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import dfep
from .graph import Graph, resolve_device


def coactivation_graph(expert_idx: np.ndarray, n_experts: int,
                       n_edges: int = 4096, seed: int = 0,
                       device=None) -> Graph:
    """expert_idx [T, k] routed expert ids per token -> sampled co-activation
    graph on ``device`` (edge multiplicity ∝ co-activation frequency; the
    reference's edges for the same seed)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    expert_idx = np.asarray(expert_idx)
    k = expert_idx.shape[1]
    pairs = []
    for i in range(k):
        for j in range(i + 1, k):
            pairs.append(np.stack([expert_idx[:, i], expert_idx[:, j]], 1))
    pairs = np.concatenate(pairs, 0)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    sel = rng.integers(0, len(pairs), size=n_edges)
    e = pairs[sel].astype(np.int32)
    u = np.minimum(e[:, 0], e[:, 1])
    v = np.maximum(e[:, 0], e[:, 1])
    pad = -(-n_edges // 128) * 128
    src = np.zeros(pad, np.int32)
    src[:n_edges] = u
    dst = np.zeros(pad, np.int32)
    dst[:n_edges] = v
    mask = np.zeros(pad, bool)
    mask[:n_edges] = True
    return Graph(n_experts, n_edges, torch.from_numpy(src).to(dev),
                 torch.from_numpy(dst).to(dev), torch.from_numpy(mask).to(dev))


@dataclasses.dataclass
class Placement:
    expert_to_shard: np.ndarray      # [E] shard id
    permutation: np.ndarray          # [E] expert order realising the placement
    shard_load: np.ndarray           # [K] expected routed-token load
    imbalance: float                 # max/mean shard load
    owner: np.ndarray | None = None  # [E_pad] DFEP's owner of each edge slot
    info: dict | None = None         # DFEP's info (rounds, starts, ...)


def _loads_per_shard(assign: np.ndarray, loads: np.ndarray, k: int) -> np.ndarray:
    return np.array([loads[assign == s].sum() for s in range(k)])


def place_experts(expert_idx: np.ndarray, n_experts: int, k: int,
                  seed: int = 0, rounds_cap: int = 2000, starts=None,
                  device=None) -> Placement:
    """Run DFEP on the co-activation graph on ``device`` and derive an
    expert placement. ``starts`` are DFEP's K start vertices, drawn from
    ``seed`` when None (``dfep.partition``'s rule)."""
    expert_idx = np.asarray(expert_idx)
    loads = np.bincount(expert_idx.reshape(-1), minlength=n_experts).astype(float)
    g = coactivation_graph(expert_idx, n_experts, seed=seed, device=device)
    owner, info = dfep.partition(g, k=k, starts=starts, seed=seed,
                                 max_rounds=rounds_cap, stall_rounds=64,
                                 device=device)
    owner = owner.cpu().numpy()
    u, v = g.src.cpu().numpy(), g.dst.cpu().numpy()
    m = g.edge_mask.cpu().numpy()
    # majority vote of incident-edge owners per expert
    votes = np.zeros((n_experts, k))
    np.add.at(votes, (u[m], owner[m]), 1.0)
    np.add.at(votes, (v[m], owner[m]), 1.0)
    assign = votes.argmax(1)
    assign[votes.sum(1) == 0] = -1

    # capacity E/K: bump overflow (lowest-vote first) to lightest shards
    cap = -(-n_experts // k)
    shard_sets: list[list[int]] = [[] for _ in range(k)]
    order = np.argsort(-loads)                     # place heavy experts first
    for e in order:
        s = assign[e]
        if s < 0 or len(shard_sets[s]) >= cap:
            s = min(range(k), key=lambda ss: (
                len(shard_sets[ss]) >= cap,
                sum(loads[x] for x in shard_sets[ss])))
        shard_sets[s].append(int(e))
    final = np.zeros(n_experts, np.int64)
    for s, es in enumerate(shard_sets):
        for e in es:
            final[e] = s
    perm = np.concatenate([np.array(sorted(es), np.int64)
                           for es in shard_sets])
    shard_load = _loads_per_shard(final, loads, k)
    imb = float(shard_load.max() / max(shard_load.mean(), 1e-9))
    return Placement(final, perm, shard_load, imb, owner, info)


def naive_imbalance(loads: np.ndarray, k: int) -> float:
    """Contiguous-blocks placement baseline (the default layout)."""
    e = len(loads)
    cap = -(-e // k)
    assign = np.arange(e) // cap
    sl = _loads_per_shard(assign, loads, k)
    return float(sl.max() / max(sl.mean(), 1e-9))


def permute_expert_params(moe_params: dict, perm) -> dict:
    """Apply a placement permutation to stacked MoE weights + router: axis
    ``ndim - 3`` of ``w_gate``/``w_up``/``w_down`` (leading dims may hold
    the layer-stack axis) and the router's last axis. Other entries (the
    shared expert) are kept as they are."""
    out = dict(moe_params)
    for name in ("w_gate", "w_up", "w_down", "router"):
        if name in out:
            w = out[name]
            axis = w.ndim - 1 if name == "router" else w.ndim - 3
            idx = torch.as_tensor(np.asarray(perm), dtype=torch.int64,
                                  device=w.device)
            out[name] = torch.index_select(w, axis, idx)
    return out

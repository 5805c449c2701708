"""Bounded local re-auction: DFEP steps 1–2 on the h-hop region around
touched vertices.

Counterpart of ``repro.stream.reauction``. Online HDRF placement
(``assign.py``) is greedy and order-dependent; as updates accumulate, its
decisions drift away from what a fresh DFEP auction would choose and the
replication factor creeps up. Instead of re-running the full market, the
session releases only the edges inside the h-hop neighbourhood of the
vertices touched since the last correction and lets the paper's funding
auction (``core/dfep.py``, ``run_dfep_region``) re-sell them, with step-3
grants restricted to region vertices so the correction cannot leak funding
into untouched territory. Ownership outside the region is frozen;
partitions anchor their bids on the presence they already hold at the
region boundary. The region is found on the host (numpy); the auction runs
on the graph's device, its rank cumsums through ``kernels.ops.lane_cumsum``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core import dfep
from ..core.graph import Graph


def h_hop_vertices(u: np.ndarray, v: np.ndarray, mask: np.ndarray,
                   n_vertices: int, seeds: np.ndarray, hops: int) -> np.ndarray:
    """Grow a vertex set by ``hops`` BFS levels over the live edges."""
    reach = seeds.copy()
    for _ in range(max(hops, 0)):
        hit = (reach[u] | reach[v]) & mask
        nxt = reach.copy()
        nxt[u[hit]] = True
        nxt[v[hit]] = True
        if np.array_equal(nxt, reach):
            break
        reach = nxt
    return reach


def local_reauction(g: Graph, owner: np.ndarray, touched: np.ndarray, k: int,
                    hops: int = 2, max_rounds: int = 400,
                    stall_rounds: int = 32, cap: int = 10
                    ) -> tuple[np.ndarray, dict]:
    """Re-auction the edges whose endpoints both lie in the h-hop region
    around ``touched`` vertices. Returns (new owner [E_pad], info); info
    holds the reference's counts and ``region_s``, the host wall seconds
    of the region auction's rounds.

    ``owner`` is the slot-parallel assignment (-2 at masked slots); only
    region edges can change hands. Slots are rebuilt here because ingestion
    mutates slot endpoints, staleing any cached sort.
    """
    u = g.src.cpu().numpy()
    v = g.dst.cpu().numpy()
    mask = g.edge_mask.cpu().numpy()
    region_v = h_hop_vertices(u, v, mask, g.n_vertices, touched, hops)
    active = mask & region_v[u] & region_v[v]
    n_active = int(active.sum())
    info = {"region_vertices": int(region_v.sum()), "active_edges": n_active,
            "rounds": 0, "region_s": 0.0}
    if n_active == 0:
        return owner.copy(), info

    dev = g.device
    slots = dfep.build_slots(g)
    cfg = dfep.DfepConfig(k=k, cap=cap, max_rounds=max_rounds,
                          stall_rounds=stall_rounds)
    t0 = time.perf_counter()
    st = dfep.run_dfep_region(
        g, slots, cfg, torch.from_numpy(owner.astype(np.int32)).to(dev),
        torch.from_numpy(active).to(dev), torch.from_numpy(region_v).to(dev))
    new_owner = st.owner
    unsold = int((new_owner == dfep.FREE).sum())   # waits for the rounds
    info["region_s"] = time.perf_counter() - t0
    if unsold:
        new_owner = dfep.finalize(g, new_owner, k)
    new_owner = torch.where(g.edge_mask, new_owner, -2).cpu().numpy() \
        .astype(np.int32)
    info["rounds"] = int(st.rounds)
    info["unsold_at_stop"] = unsold
    info["moved_edges"] = int(((new_owner != owner) & mask).sum())
    return new_owner, info

"""Distributed DFEP over a ``torch.distributed`` process group: the paper's
one-MapReduce-round-per-iteration scheme, one rank a worker.

Counterpart of ``repro.core.dfep_distributed``, integer for integer: given
the same start vertices and the same number of ranks as the reference has
devices, it sells the same edges in the same rounds.

  * the *edge* set (and its funding slots) is split into one contiguous
    block a rank (:func:`shard_graph`, host numpy; every rank holds the
    whole graph and takes its own row);
  * the [V, K] vertex-funding matrix is replicated and reconciled with an
    ``all_reduce`` (sum) where the reference ``psum``s: the shuffle of the
    paper's MR round, the only cross-worker traffic beside a few [K]
    counts;
  * the auction (step 2) runs rank-locally: every edge lives on exactly
    one rank;
  * the coordinator (step 3) is O(K) and replicated: every rank computes
    the same grants.

Step-1 remainder units are ranked among a vertex's *rank-local* eligible
slots, the rank's index salts the rotation hash and its block offset the
tie hash's edge id, as in the reference. The two rank cumsums of a round,
down [2·E_loc, K] and [V, K], go through ``kernels.ops.lane_cumsum``. The
rounds run as a Python loop that reads the device once a round: the
all-reduced count of unsold edges (with the count of sales, in the same
read).

At the end each rank scatters its block into a zero [ndev·E_loc] owner
array and the ranks sum it, so every rank returns the whole owner array.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels import ops
from . import collectives as C
from .dfep import (FREE, DfepConfig, Slots, _hash01, _sizes, finalize,
                   init_state)
from .graph import Graph, resolve_device


class ShardedGraph(NamedTuple):
    """Edge-sharded graph + per-shard slot layout (rank-major leading dim),
    host numpy: every array has a leading [ndev] axis, row ``r`` being
    rank ``r``'s contiguous edge block and its slots."""
    n_vertices: int
    n_edges: int
    src: np.ndarray        # [ndev, E_loc] int32
    dst: np.ndarray        # [ndev, E_loc] int32
    edge_mask: np.ndarray  # [ndev, E_loc] bool
    slot_edge: np.ndarray  # [ndev, 2*E_loc] local edge index of sorted slot
    slot_vertex: np.ndarray
    slot_seg_first: np.ndarray
    slot_inv: np.ndarray


def shard_graph(g: Graph, ndev: int) -> ShardedGraph:
    """Host-side: split edges into ``ndev`` contiguous blocks (padded) and
    build each worker's vertex-sorted slot layout."""
    u, v = g.src.cpu().numpy(), g.dst.cpu().numpy()
    em = g.edge_mask.cpu().numpy()
    e_pad = g.e_pad
    e_loc = -(-e_pad // ndev)
    tot = e_loc * ndev
    pu = np.zeros(tot, np.int32)
    pu[:e_pad] = u
    pv = np.zeros(tot, np.int32)
    pv[:e_pad] = v
    pm = np.zeros(tot, bool)
    pm[:e_pad] = em
    pu, pv, pm = (x.reshape(ndev, e_loc) for x in (pu, pv, pm))

    se = np.zeros((ndev, 2 * e_loc), np.int32)
    sv = np.zeros((ndev, 2 * e_loc), np.int32)
    sf = np.zeros((ndev, 2 * e_loc), np.int32)
    si = np.zeros((ndev, 2 * e_loc), np.int32)
    for d in range(ndev):
        slot_vertex = np.concatenate([pu[d], pv[d]])
        slot_edge = np.concatenate([np.arange(e_loc),
                                    np.arange(e_loc)]).astype(np.int32)
        order = np.argsort(slot_vertex, kind="stable").astype(np.int32)
        svd = slot_vertex[order].astype(np.int32)
        sed = slot_edge[order]
        first = np.zeros(g.n_vertices, np.int32)
        seen = np.ones(len(svd), bool)
        seen[1:] = svd[1:] != svd[:-1]
        first[svd[seen]] = np.flatnonzero(seen)
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order), dtype=np.int32)
        se[d], sv[d], sf[d], si[d] = sed, svd, first[svd], inv
    return ShardedGraph(g.n_vertices, g.n_edges, pu, pv, pm, se, sv, sf, si)


class _Block(NamedTuple):
    """One rank's edge block on its device, indices widened to int64."""
    src: torch.Tensor      # [E_loc]
    dst: torch.Tensor      # [E_loc]
    emask: torch.Tensor    # [E_loc] bool
    slots: Slots           # [2·E_loc] each


def _block(sg: ShardedGraph, my: int, dev) -> _Block:
    def t(a):
        return torch.from_numpy(a[my].astype(np.int64)).to(dev)

    return _Block(t(sg.src), t(sg.dst),
                  torch.from_numpy(sg.edge_mask[my].copy()).to(dev),
                  Slots(t(sg.slot_edge), t(sg.slot_vertex),
                        t(sg.slot_seg_first), t(sg.slot_inv)))


def _round(blk: _Block, cfg: DfepConfig, n_vertices: int, n_edges: int,
           my: int, owner: torch.Tensor, mv: torch.Tensor, rounds: int,
           group) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One auction round on this rank's block. Returns (owner block, mv,
    [unsold, sold] int32 over all ranks)."""
    k = cfg.k
    dev = owner.device
    i32 = torch.int32
    u, v, emask, slots = blk.src, blk.dst, blk.emask, blk.slots
    e_loc = int(u.shape[0])
    part_ids = torch.arange(k, dtype=i32, device=dev)

    free = owner == FREE
    owned_by = owner[:, None] == part_ids[None, :]                   # [E, K]
    elig = (free[:, None] | owned_by) & emask[:, None]
    if cfg.variant_c:
        sizes0 = C.all_reduce_(_sizes(owner, k), "sum", group)
        mean0 = sizes0.sum(dtype=i32) // k
        poor = sizes0 < (mean0 / cfg.poor_p)
        rich_edge = torch.where(owner >= 0,
                                ~poor[owner.clamp(min=0).to(torch.int64)],
                                False)
        raid = rich_edge[:, None] & poor[None, :] & ~owned_by & emask[:, None]
        elig = elig | raid

    eligi = elig.to(i32)
    cnt = torch.zeros((n_vertices, k), dtype=i32, device=dev)
    cnt.index_add_(0, u, eligi)
    cnt.index_add_(0, v, eligi)
    C.all_reduce_(cnt, "sum", group)                         # MR shuffle #1
    safe_cnt = cnt.clamp(min=1)
    base = mv // safe_cnt
    rem = mv - base * safe_cnt

    # rank among the vertex's eligible slots of this block, rotated by a
    # per-(vertex, rank, partition, round) hash: hashed over [V, K] and
    # gathered per slot (the values the reference hashes per slot)
    elig_slot = eligi[slots.edge]                                  # [2E, K]
    cum = ops.lane_cumsum(elig_slot)
    exc = cum - elig_slot
    rank = exc - exc[slots.seg_first]
    sv = slots.vertex
    verts = torch.arange(n_vertices, dtype=i32, device=dev)
    rot_v = (_hash01(verts[:, None] * 131 + my, part_ids[None, :], rounds)
             * safe_cnt.to(torch.float32)).to(i32)                   # [V, K]
    cnt_s = safe_cnt[sv]
    rank = (rank + rot_v[sv]) % cnt_s
    contrib = elig_slot * (base[sv] + (rank < rem[sv]).to(i32))
    mv_left = torch.where(cnt > 0, 0, mv)

    contrib_uv = contrib[slots.inv]
    cu, cv = contrib_uv[:e_loc], contrib_uv[e_loc:]
    me = cu + cv

    tie = _hash01(torch.arange(e_loc, dtype=i32, device=dev)[:, None]
                  + my * e_loc, part_ids[None, :], rounds)
    score = me.to(torch.float32) + tie
    best = torch.argmax(score, dim=1)                         # first max
    best_amt = torch.gather(me, 1, best[:, None])[:, 0]
    best = best.to(i32)
    can_buy = (best_amt >= 1) & emask
    bought_free = free & can_buy
    if cfg.variant_c:
        steal = ((~free) & can_buy & poor[best.to(torch.int64)]
                 & (best != owner) & rich_edge)
        paid = bought_free | steal
    else:
        paid = bought_free
    new_owner = torch.where(paid, best, owner)

    now_owned = new_owner[:, None] == part_ids[None, :]
    pay = (paid[:, None] & now_owned).to(i32)
    residual = me - pay
    fu = (cu > 0).to(i32)
    fv = (cv > 0).to(i32)
    funders = (fu + fv).clamp(min=1)
    half = residual // 2
    loser_share = residual // funders
    loser_rem = residual - loser_share * funders
    ref_u = torch.where(now_owned, half + (residual - 2 * half),
                        fu * (loser_share + loser_rem * fu))
    ref_v = torch.where(now_owned, half,
                        fv * torch.where(fu > 0, loser_share,
                                         loser_share + loser_rem))
    dmv = torch.zeros((n_vertices, k), dtype=i32, device=dev)
    dmv.index_add_(0, u, ref_u)
    dmv.index_add_(0, v, ref_v)
    mv_new = mv_left + C.all_reduce_(dmv, "sum", group)      # MR shuffle #2

    # step 3 — replicated coordinator: partition sizes, unsold edges and
    # sales of this round, summed over the ranks in one reduce
    still_free = new_owner == FREE
    counts = torch.cat([_sizes(new_owner, k),
                        still_free.sum(dtype=i32).reshape(1),
                        paid.sum(dtype=i32).reshape(1)])
    C.all_reduce_(counts, "sum", group)
    sizes, remaining = counts[:k], counts[k]
    grant = torch.clamp((n_edges + sizes.clamp(min=1) - 1)
                        // sizes.clamp(min=1), max=cfg.cap)
    grant = torch.where(remaining > 0, grant, 0).to(i32)

    # frontier and presence flags at each vertex, summed over the ranks in
    # one reduce ([2, V, K] int32, tested > 0)
    flags = torch.zeros((2, n_vertices, k), dtype=i32, device=dev)
    flags[0].index_add_(0, u, ((cu > 0) & still_free[:, None]).to(i32))
    flags[0].index_add_(0, v, ((cv > 0) & still_free[:, None]).to(i32))
    owned_mask = (now_owned & emask[:, None]).to(i32)
    flags[1].index_add_(0, u, owned_mask)
    flags[1].index_add_(0, v, owned_mask)
    C.all_reduce_(flags, "sum", group)
    fr, owned_any = flags[0] > 0, flags[1] > 0
    presence = (mv_new > 0) | owned_any
    has_frontier = fr.any(dim=0)
    presence = torch.where(has_frontier[None, :], fr, presence)
    pres_i = presence.to(i32)
    n_pres = pres_i.sum(dim=0, dtype=i32).clamp(min=1)
    p_base = grant // n_pres
    p_rem = grant - p_base * n_pres
    p_rank = ops.lane_cumsum(pres_i) - pres_i
    seven = torch.full((1,), 7, dtype=i32, device=dev)
    p_rot = (_hash01(seven[:, None], part_ids[None, :], rounds)
             * n_pres.to(torch.float32)).to(i32)
    p_rank = (p_rank + p_rot) % n_pres[None, :]
    mv_new = mv_new + pres_i * (p_base[None, :]
                                + (p_rank < p_rem[None, :]).to(i32))
    return new_owner, mv_new, counts[k:]


def run_dfep_sharded(g: Graph, cfg: DfepConfig, starts, group=None,
                     device=None) -> tuple[torch.Tensor, dict]:
    """Run DFEP edge-sharded over the ranks of ``group`` (``None``: the
    default group), every rank calling it with the same graph, config and
    ``starts`` (the K start vertices: the reference draws them from its
    key with ``jax.random.choice``). Runs on ``device`` (``None``:
    ``cuda``, the rank's current card). Returns (owner [E_pad] int32, the
    same on every rank; info with the reference's keys)."""
    ndev, my = C.world(group), C.rank(group)
    dev = resolve_device(device)
    if g.device != dev:
        g = g.to(dev)
    sg = shard_graph(g, ndev)
    e_loc = int(sg.src.shape[1])
    blk = _block(sg, my, dev)
    mv = init_state(g, cfg, starts).mv                   # replicated [V, K]
    owner = torch.where(blk.emask, FREE, -2).to(torch.int32)

    unsold = int(C.all_reduce_((owner == FREE).sum(dtype=torch.int32)
                               .reshape(1), "sum", group))
    rounds = stalled = 0
    while (unsold > 0 and rounds < cfg.max_rounds
           and stalled < cfg.stall_rounds):
        owner, mv, tail = _round(blk, cfg, g.n_vertices, g.n_edges, my,
                                 owner, mv, rounds, group)
        unsold, sold = tail.tolist()
        rounds += 1
        stalled = 0 if sold > 0 else stalled + 1

    whole = torch.zeros(ndev * e_loc, dtype=torch.int32, device=dev)
    whole[my * e_loc:(my + 1) * e_loc] = owner
    owner_flat = C.all_reduce_(whole, "sum", group)[:g.e_pad]
    if unsold:
        owner_flat = finalize(g, owner_flat, cfg.k)
        owner_flat = torch.where(g.edge_mask, owner_flat, -2).to(torch.int32)
    info = {"rounds": rounds, "unsold_at_stop": unsold,
            "finalized": bool(unsold), "ndev": ndev}
    return owner_flat, info

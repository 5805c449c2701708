"""DFEP — Distributed Funding-based Edge Partitioning (paper §IV) in PyTorch.

Counterpart of ``repro.core.dfep``, integer for integer: given the same
start vertices it sells the same edges in the same rounds, so the owner
array and the round count equal the reference's. Funding is kept in integer
units; one round is the paper's (step 1, step 2, step 3):

  step 1  every vertex spreads each partition's units over incident
          *eligible* edges (free, or owned by that partition; DFEP-C
          additionally lets "poor" partitions bid on "rich" edges);
  step 2  every free edge is sold to the highest bidder with ≥ 1 unit
          (ties broken by a per-round hash), winner pays 1, residual splits
          half/half (odd unit to the lower endpoint), losers refunded
          equally over their funding endpoints (odd unit to the first);
  step 3  the coordinator grants each partition ``min(cap, ceil(|E|/size))``
          units, spread over its frontier (or presence) vertices.

The rounds run as a Python loop on the graph's device; the loop test is one
device→host read per round. The two rank cumsums of a round, down [2E, K]
and [V, K], go through ``kernels.ops.lane_cumsum`` (a Hopper kernel on the
card, ``torch.cumsum`` on the CPU). ``argmax`` keeps the first index on
ties, as ``jnp.argmax`` does; boolean scatter-``max`` becomes an integer
scatter-add tested ``> 0``; ``_hash01`` emulates uint32 arithmetic in
int64.

:func:`run_dfep_region` runs the same rounds over a region of the graph
(the streaming session's bounded local re-auction): ``_round``'s
``active`` edges are re-sold and its grants stay on ``grant_v`` vertices.

The reference draws the K start vertices with ``jax.random.choice``, which
torch cannot reproduce: :func:`partition` takes them as ``starts`` and
otherwise draws them from a seeded ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import ops
from .graph import Graph, resolve_device

FREE = -1  # owner value for unsold edges
_M32 = 0xFFFFFFFF


class Slots(NamedTuple):
    """Directed slot layout: 2 slots per undirected edge (u-side, v-side),
    sorted by slot vertex so per-vertex ranks are a segmented cumsum.
    The reference's int32 values, widened once to int64 for indexing."""
    edge: torch.Tensor        # [2E] edge id of sorted slot
    vertex: torch.Tensor      # [2E] vertex of sorted slot
    seg_first: torch.Tensor   # [2E] sorted-index of this vertex's first slot
    inv: torch.Tensor         # [2E] sorted idx of (u-sides ++ v-sides) slot


def build_slots(g: Graph) -> Slots:
    u = g.src.cpu().numpy()
    v = g.dst.cpu().numpy()
    e = g.e_pad
    slot_vertex = np.concatenate([u, v])
    slot_edge = np.concatenate([np.arange(e), np.arange(e)]).astype(np.int32)
    order = np.argsort(slot_vertex, kind="stable").astype(np.int32)
    sv = slot_vertex[order].astype(np.int32)
    se = slot_edge[order]
    # first sorted index of each vertex segment
    first_of_vertex = np.zeros(g.n_vertices, np.int32)
    seen = np.ones(len(sv), bool)
    seen[1:] = sv[1:] != sv[:-1]
    first_of_vertex[sv[seen]] = np.flatnonzero(seen)
    seg_first = first_of_vertex[sv]
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order), dtype=np.int32)

    def t(a):
        return torch.from_numpy(a.astype(np.int64)).to(g.device)

    return Slots(t(se), t(sv), t(seg_first), t(inv))


@dataclasses.dataclass(frozen=True)
class DfepState:
    owner: torch.Tensor    # [E] int32, FREE where unsold (padding slots: -2)
    mv: torch.Tensor       # [V, K] int32 vertex funding
    rounds: torch.Tensor   # 0-d int32
    stalled: torch.Tensor  # 0-d int32 — rounds without progress


@dataclasses.dataclass(frozen=True)
class DfepConfig:
    k: int                       # number of partitions
    cap: int = 10                # per-round funding cap (paper: 10)
    variant_c: bool = False      # DFEP-C: poor partitions may raid rich ones
    poor_p: float = 2.0          # poor iff size < mean/p  (paper's parameter p)
    max_rounds: int = 10_000
    stall_rounds: int = 256      # no-progress rounds before bailing out
    init_funding: int | None = None  # default ceil(|E|/K) (paper §IV)


def draw_starts(n_vertices: int, k: int, seed: int = 0) -> torch.Tensor:
    """K distinct start vertices from a seeded CPU ``torch.Generator`` —
    the same vertices on every device."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randperm(n_vertices, generator=gen)[:k]


def _start_list(starts) -> list[int]:
    """Start vertices from a tensor (any device), array or sequence."""
    if isinstance(starts, torch.Tensor):
        starts = starts.cpu().numpy()
    return [int(s) for s in np.asarray(starts).reshape(-1)]


def init_state(g: Graph, cfg: DfepConfig, starts) -> DfepState:
    """Algorithm 3: K distinct starting vertices, ceil(|E|/K) units each."""
    k = cfg.k
    dev = g.device
    starts = _start_list(starts)
    if len(starts) != k or len(set(starts)) != k:
        raise ValueError(f"starts must be {k} distinct vertex ids, got {starts}")
    starts = torch.tensor(starts, dtype=torch.int64, device=dev)
    funding = cfg.init_funding if cfg.init_funding is not None else -(-g.n_edges // k)
    mv = torch.zeros((g.n_vertices, k), dtype=torch.int32, device=dev)
    mv[starts, torch.arange(k, device=dev)] = int(funding)
    owner = torch.where(g.edge_mask, FREE, -2).to(torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return DfepState(owner, mv, zero, zero.clone())


def _hash01(e, i, r) -> torch.Tensor:
    """Stateless per-(edge, partition, round) tie-break in [0, 1): the
    reference's uint32 multiply/xor/shift hash, emulated in int64 with a
    32-bit mask after every step (each product stays below 2**63 for
    non-negative int32 inputs). float32 conversion and the /2**32 are
    bit-equal to the reference's."""
    def u32(a):
        return torch.as_tensor(a).to(torch.int64) & _M32

    x = (((u32(e) * 0x9E3779B1) & _M32)
         ^ ((u32(i) * 0x85EBCA77) & _M32)
         ^ ((u32(r) * 0xC2B2AE3D) & _M32))
    x = ((x ^ (x >> 15)) * 0x2C1B3C6D) & _M32
    x = ((x ^ (x >> 12)) * 0x297A2D39) & _M32
    x = x ^ (x >> 15)
    return x.to(torch.float32) / float(2**32)


def _sizes(owner: torch.Tensor, k: int) -> torch.Tensor:
    """Edges owned per partition, [K] int32 (FREE and padding not counted)."""
    counts = torch.zeros(k + 2, dtype=torch.int32, device=owner.device)
    counts.index_add_(0, (owner + 2).to(torch.int64),
                      torch.ones_like(owner, dtype=torch.int32))
    return counts[2:]


def _scatter_any(n: int, idx: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """[n, K] bool: OR of ``flags`` rows scattered to ``idx`` (the
    reference's boolean scatter-max, as an exact integer scatter-add)."""
    acc = torch.zeros((n, flags.shape[1]), dtype=torch.int32,
                      device=flags.device)
    acc.index_add_(0, idx, flags.to(torch.int32))
    return acc > 0


def _round(g: Graph, slots: Slots, cfg: DfepConfig, state: DfepState,
           active: torch.Tensor | None = None,
           grant_v: torch.Tensor | None = None) -> DfepState:
    """One auction round. ``active`` ([E] bool, default: every real edge)
    restricts steps 1–2 to a subset of edges, and ``grant_v`` ([V] bool)
    restricts step-3 grants to those vertices: the bounded local
    re-auction of ``repro_torch.stream`` runs this with both set to its
    h-hop region. With both None this is the paper's full-graph round."""
    k = cfg.k
    dev = g.device
    u, v = g.src, g.dst
    emask = g.edge_mask if active is None else (g.edge_mask & active)
    owner, mv = state.owner, state.mv
    part_ids = torch.arange(k, dtype=torch.int32, device=dev)
    i32 = torch.int32

    free = owner == FREE                                             # [E]
    owned_by = owner[:, None] == part_ids[None, :]                   # [E, K]

    # ---- step 1: spread units over eligible incident edges ---------------
    elig = (free[:, None] | owned_by) & emask[:, None]               # [E, K]
    if cfg.variant_c:
        sizes0 = _sizes(owner, k)
        mean0 = sizes0.sum(dtype=i32) // k
        poor = sizes0 < (mean0 / cfg.poor_p)                         # [K]
        rich_edge = torch.where(owner >= 0,
                                ~poor[owner.clamp(min=0).to(torch.int64)],
                                False)
        raid = rich_edge[:, None] & poor[None, :] & ~owned_by & emask[:, None]
        elig = elig | raid

    eligi = elig.to(i32)
    cnt = torch.zeros((g.n_vertices, k), dtype=i32, device=dev)
    cnt.index_add_(0, u, eligi)
    cnt.index_add_(0, v, eligi)                                      # [V, K]
    safe_cnt = cnt.clamp(min=1)
    base = mv // safe_cnt                                            # [V, K]
    rem = mv - base * safe_cnt                                       # [V, K]

    # per-slot rank among this vertex's eligible edges (segmented cumsum),
    # rotated by a per-(vertex, partition, round) hash. The rotation depends
    # on the vertex only, so it is hashed over [V, K] and gathered per slot
    # (the same values the reference hashes per slot).
    elig_slot = eligi[slots.edge]                                    # [2E, K]
    cum = ops.lane_cumsum(elig_slot)
    exc = cum - elig_slot                                            # exclusive
    rank = exc - exc[slots.seg_first]                                # [2E, K]
    sv = slots.vertex
    verts = torch.arange(g.n_vertices, dtype=i32, device=dev)
    rot_v = (_hash01(verts[:, None], part_ids[None, :], state.rounds)
             * safe_cnt.to(torch.float32)).to(i32)                   # [V, K]
    cnt_s = safe_cnt[sv]
    rank = torch.where(cnt_s > 0, (rank + rot_v[sv]) % cnt_s, rank)
    contrib = elig_slot * (base[sv] + (rank < rem[sv]).to(i32))
    moved = cnt > 0
    mv_left = torch.where(moved, 0, mv)                              # [V, K]

    # back to (u-side, v-side) order
    e_pad = g.e_pad
    contrib_uv = contrib[slots.inv]                                  # [2E, K]
    cu, cv = contrib_uv[:e_pad], contrib_uv[e_pad:]                  # [E, K]
    me = cu + cv                                                     # committed

    # ---- step 2: auction --------------------------------------------------
    tie = _hash01(torch.arange(e_pad, dtype=i32, device=dev)[:, None],
                  part_ids[None, :], state.rounds)
    score = me.to(torch.float32) + tie
    best = torch.argmax(score, dim=1)                                # [E] first max
    best_amt = torch.gather(me, 1, best[:, None])[:, 0]
    best = best.to(i32)
    can_buy = (best_amt >= 1) & emask
    bought_free = free & can_buy
    if cfg.variant_c:
        best_is_poor = poor[best.to(torch.int64)]
        steal = (~free) & can_buy & best_is_poor & (best != owner) & rich_edge
        paid = bought_free | steal
    else:
        paid = bought_free
    new_owner = torch.where(paid, best, owner)

    now_owned = new_owner[:, None] == part_ids[None, :]              # [E, K]
    pay = (paid[:, None] & now_owned).to(i32)
    residual = me - pay                                              # [E, K]

    # winner residual: half/half (odd unit to u). losers: equal over funders
    fu = (cu > 0).to(i32)
    fv = (cv > 0).to(i32)
    funders = (fu + fv).clamp(min=1)
    half = residual // 2
    loser_share = residual // funders
    loser_rem = residual - loser_share * funders                     # 0 or 1
    ref_u = torch.where(now_owned, half + (residual - 2 * half),
                        fu * (loser_share + loser_rem * fu))
    ref_v = torch.where(now_owned, half,
                        fv * torch.where(fu > 0, loser_share,
                                         loser_share + loser_rem))
    mv_new = mv_left.clone()
    mv_new.index_add_(0, u, ref_u)
    mv_new.index_add_(0, v, ref_v)

    # ---- step 3: coordinator grants (replicated, O(K)) --------------------
    # grant_i = min(cap, ceil(|E| / size_i))
    sizes = _sizes(new_owner, k)
    still_free = new_owner == FREE                                   # [E]
    remaining = still_free.sum()
    grant = torch.clamp((g.n_edges + sizes.clamp(min=1) - 1)
                        // sizes.clamp(min=1), max=cfg.cap)
    grant = torch.where(remaining > 0, grant, 0).to(i32)             # [K]

    # distribute over the vertices where the partition committed funding to
    # a still-free edge this round (its active frontier); if it has no such
    # vertex, fall back to its full presence set.
    fr_u = (_scatter_any(g.n_vertices, u, (cu > 0) & still_free[:, None])
            | _scatter_any(g.n_vertices, v, (cv > 0) & still_free[:, None]))
    owned_mask = now_owned & emask[:, None]
    owned_at = (_scatter_any(g.n_vertices, u, owned_mask)
                | _scatter_any(g.n_vertices, v, owned_mask))
    presence = (mv_new > 0) | owned_at
    has_frontier = fr_u.any(dim=0)                                   # [K]
    presence = torch.where(has_frontier[None, :], fr_u, presence)
    if grant_v is not None:   # local re-auction: grants stay in the region
        presence = presence & grant_v[:, None]
    pres_i = presence.to(i32)
    n_pres = pres_i.sum(dim=0, dtype=i32).clamp(min=1)               # [K]
    p_base = grant // n_pres
    p_rem = grant - p_base * n_pres                                  # [K]
    p_rank = ops.lane_cumsum(pres_i) - pres_i                      # [V, K]
    seven = torch.full((1,), 7, dtype=i32, device=dev)
    p_rot = (_hash01(seven[:, None], part_ids[None, :], state.rounds)
             * n_pres.to(torch.float32)).to(i32)                     # [1, K]
    p_rank = (p_rank + p_rot) % n_pres[None, :]
    mv_new = mv_new + pres_i * (p_base[None, :]
                                + (p_rank < p_rem[None, :]).to(i32))

    progressed = paid.any()
    return DfepState(
        owner=new_owner,
        mv=mv_new,
        rounds=state.rounds + 1,
        stalled=torch.where(progressed, 0, state.stalled + 1).to(i32),
    )


def _run_rounds(g: Graph, slots: Slots, cfg: DfepConfig, state: DfepState,
                active=None, grant_v=None) -> DfepState:
    """Rounds until every real edge is owned (or stall/round caps hit).
    One device→host read per round decides whether to go on."""
    while True:
        unsold = (state.owner == FREE).sum()
        go = ((unsold > 0) & (state.rounds < cfg.max_rounds)
              & (state.stalled < cfg.stall_rounds))
        if not bool(go):
            return state
        state = _round(g, slots, cfg, state, active, grant_v)


def run_dfep(g: Graph, slots: Slots, cfg: DfepConfig, starts) -> DfepState:
    """Run rounds until every real edge is owned (or stall/round caps hit)."""
    return _run_rounds(g, slots, cfg, init_state(g, cfg, starts))


# ---------------------------------------------------------------------------
# Incremental (region-restricted) DFEP — entry points for repro_torch.stream
# ---------------------------------------------------------------------------

def init_region_state(g: Graph, cfg: DfepConfig, owner: torch.Tensor,
                      active: torch.Tensor,
                      region_v: torch.Tensor) -> DfepState:
    """Seed a bounded local re-auction.

    Edges under ``active`` are released (owner -> FREE); each partition gets
    ``ceil(|active| / K)`` units spread over its presence vertices *inside*
    the region (anchoring the auction to its existing territory). A
    partition with no region presence seeds at the first region vertex, like
    Algorithm 3's random start.
    """
    k = cfg.k
    dev = g.device
    i32 = torch.int32
    owner0 = torch.where(active, FREE, owner).to(i32)
    n_active = int(active.sum())
    funding = -(-n_active // k)                                      # ceil
    # partition presence at region vertices (from still-owned edges)
    part_ids = torch.arange(k, dtype=i32, device=dev)
    owned = (owner0[:, None] == part_ids[None, :]) & g.edge_mask[:, None]
    pres = (_scatter_any(g.n_vertices, g.src, owned)
            | _scatter_any(g.n_vertices, g.dst, owned)) & region_v[:, None]
    pres_i = pres.to(i32)
    cnt = pres_i.sum(dim=0, dtype=i32)                               # [K]
    safe = cnt.clamp(min=1)
    base = funding // safe
    rem = funding - base * safe
    rank = ops.lane_cumsum(pres_i) - pres_i
    mv = pres_i * (base[None, :] + (rank < rem[None, :]).to(i32))
    # no-presence fallback: everything at the first region vertex
    fallback = int(torch.argmax(region_v.to(i32)))
    mv[fallback] += torch.where(cnt == 0, funding, 0).to(i32)
    zero = torch.zeros((), dtype=i32, device=dev)
    return DfepState(owner0, mv, zero, zero.clone())


def run_dfep_region(g: Graph, slots: Slots, cfg: DfepConfig,
                    owner: torch.Tensor, active: torch.Tensor,
                    region_v: torch.Tensor) -> DfepState:
    """DFEP steps 1–2 (plus region-restricted step-3 grants) over only the
    ``active`` edges, holding every other assignment fixed: the bounded
    local re-auction the streaming session runs when replication drift
    crosses its threshold. The loop is :func:`run_dfep`'s."""
    state = init_region_state(g, cfg, owner, active, region_v)
    return _run_rounds(g, slots, cfg, state, active, region_v)


def finalize(g: Graph, owner: torch.Tensor, k: int,
             iters: int = 64) -> torch.Tensor:
    """Assign any leftover FREE edges to the least-loaded adjacent partition
    (fallback so a valid partitioning is always returned; flagged upstream)."""
    inf = float("inf")
    src = g.src.to(torch.int64)
    dst = g.dst.to(torch.int64)
    own = owner
    for _ in range(iters):
        sizes = _sizes(own, k).to(torch.float32)
        live = own >= 0
        own_c = own.clamp(min=0)
        # per-vertex: adjacent partition with the smallest size
        score = torch.where(live, sizes[own_c.to(torch.int64)], inf)
        enc = score * (k + 1) + own_c.to(torch.float32)
        enc = torch.where(live & g.edge_mask, enc, inf)
        best_lab = torch.full((g.n_vertices,), inf, dtype=torch.float32,
                              device=g.device)
        best_lab.scatter_reduce_(0, src, enc, "amin")
        best_lab.scatter_reduce_(0, dst, enc, "amin")
        cand_enc = torch.minimum(best_lab[src], best_lab[dst])
        finite = torch.isfinite(cand_enc)
        lab = torch.fmod(torch.where(finite, cand_enc, 0.0), k + 1)
        cand = torch.where(finite, lab.to(torch.int32), -1)
        take = (own == FREE) & (cand >= 0)
        own = torch.where(take, cand, own)
    return torch.where(own == FREE, 0, own).to(torch.int32)


def partition(g: Graph, k: int, starts=None, seed: int = 0,
              variant_c: bool = False, slots: Slots | None = None,
              device=None, **kw) -> tuple[torch.Tensor, dict]:
    """Run DFEP on ``device`` and return (owner [E] int32, info dict).

    ``starts`` are the K start vertices; without them they are drawn from a
    ``torch.Generator`` seeded with ``seed``. ``info["starts"]`` records the
    ones used.
    """
    dev = resolve_device(device)
    if g.device != dev:
        g = g.to(dev)
    if starts is None:
        starts = draw_starts(g.n_vertices, k, seed)
    if slots is None:
        slots = build_slots(g)
    cfg = DfepConfig(k=k, variant_c=variant_c, **kw)
    st = run_dfep(g, slots, cfg, starts)
    unsold = int((st.owner == FREE).sum())
    owner = finalize(g, st.owner, k) if unsold else st.owner
    owner = torch.where(g.edge_mask, owner, -2).to(torch.int32)
    info = {"rounds": int(st.rounds), "unsold_at_stop": unsold,
            "finalized": bool(unsold),
            "starts": _start_list(starts)}
    return owner, info

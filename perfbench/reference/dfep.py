"""DFEP, the paper's funding-based edge partitioner, frozen in plain torch.

A copy of the integer rounds of ``src/repro_torch/core/dfep.py`` (DFEP
without the DFEP-C raids): ``build_slots``, ``init_state``, ``_round``,
``_run_rounds``, ``finalize`` and ``partition``. Given the same graph slots
and start vertices it sells the same edges in the same rounds. Departures
from the copied code, none of which changes a value:

* the two rank cumsums of a round are ``torch.cumsum`` over the K columns
  laid end to end (one flat int32 scan, each column's offset taken off),
  in place of the program's ``lane_cumsum`` kernel;
* the state is plain locals in place of a dataclass;
* ``dtype`` is the precision of a round's float32 parts: the tie-break
  hash, the rotations and the bid scores. float32 is DFEP's own; the
  benchmark's control runs bfloat16. ``finalize`` stays float32: its floats
  encode integers (a size and a label) and carry no stated precision.

Runs on any device; the benchmark runs it on the card after the window.
"""
from __future__ import annotations

import numpy as np
import torch

from . import EdgeList

FREE = -1
_M32 = 0xFFFFFFFF


def build_slots(g: EdgeList, device):
    """Two slots per edge slot (u side, v side), sorted stably by vertex:
    (edge, vertex, first sorted index of the vertex, sorted index of each
    u-sides-then-v-sides slot), int64 on ``device``."""
    u = np.asarray(g.src, np.int64)
    v = np.asarray(g.dst, np.int64)
    e = len(u)
    slot_vertex = np.concatenate([u, v])
    slot_edge = np.concatenate([np.arange(e), np.arange(e)])
    order = np.argsort(slot_vertex, kind="stable")
    sv = slot_vertex[order]
    se = slot_edge[order]
    first = np.zeros(g.n_vertices, np.int64)
    head = np.ones(len(sv), bool)
    head[1:] = sv[1:] != sv[:-1]
    first[sv[head]] = np.flatnonzero(head)
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)

    return t(se), t(sv), t(first[sv]), t(inv)


def cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 cumsum down the rows of x [N, K], exact: the columns
    scanned end to end as one flat array, each column's start taken off."""
    n, k = x.shape
    flat = torch.cumsum(x.t().reshape(-1), 0, dtype=torch.int32).view(k, n)
    before = torch.zeros(k, dtype=torch.int32, device=x.device)
    before[1:] = flat[:-1, -1]
    return (flat - before[:, None]).t()


def hash01(e, i, r, dtype) -> torch.Tensor:
    """The per-(edge or vertex, partition, round) tie-break in [0, 1): a
    uint32 multiply/xor/shift hash in int64 with a 32-bit mask."""
    def u32(a):
        return torch.as_tensor(a).to(torch.int64) & _M32

    x = (((u32(e) * 0x9E3779B1) & _M32)
         ^ ((u32(i) * 0x85EBCA77) & _M32)
         ^ ((u32(r) * 0xC2B2AE3D) & _M32))
    x = ((x ^ (x >> 15)) * 0x2C1B3C6D) & _M32
    x = ((x ^ (x >> 12)) * 0x297A2D39) & _M32
    x = x ^ (x >> 15)
    return x.to(dtype) / float(2**32)


def sizes(owner: torch.Tensor, k: int) -> torch.Tensor:
    counts = torch.zeros(k + 2, dtype=torch.int32, device=owner.device)
    counts.index_add_(0, (owner + 2).to(torch.int64),
                      torch.ones_like(owner, dtype=torch.int32))
    return counts[2:]


def scatter_any(n: int, idx: torch.Tensor, flags: torch.Tensor):
    acc = torch.zeros((n, flags.shape[1]), dtype=torch.int32,
                      device=flags.device)
    acc.index_add_(0, idx, flags.to(torch.int32))
    return acc > 0


def dfep_round(n_vertices, n_edges, u, v, emask, slots, k, cap, owner, mv,
               rounds, dtype):
    """One auction round; returns (owner, mv, progressed)."""
    s_edge, s_vertex, s_first, s_inv = slots
    dev = u.device
    i32 = torch.int32
    part_ids = torch.arange(k, dtype=i32, device=dev)
    free = owner == FREE
    owned_by = owner[:, None] == part_ids[None, :]

    # step 1: spread units over eligible incident edges
    elig = (free[:, None] | owned_by) & emask[:, None]
    eligi = elig.to(i32)
    cnt = torch.zeros((n_vertices, k), dtype=i32, device=dev)
    cnt.index_add_(0, u, eligi)
    cnt.index_add_(0, v, eligi)
    safe_cnt = cnt.clamp(min=1)
    base = mv // safe_cnt
    rem = mv - base * safe_cnt
    elig_slot = eligi[s_edge]
    exc = cumsum_rows(elig_slot) - elig_slot
    rank = exc - exc[s_first]
    verts = torch.arange(n_vertices, dtype=i32, device=dev)
    rot_v = (hash01(verts[:, None], part_ids[None, :], rounds, dtype)
             * safe_cnt.to(dtype)).to(i32)
    cnt_s = safe_cnt[s_vertex]
    rank = torch.where(cnt_s > 0, (rank + rot_v[s_vertex]) % cnt_s, rank)
    contrib = elig_slot * (base[s_vertex] + (rank < rem[s_vertex]).to(i32))
    mv_left = torch.where(cnt > 0, 0, mv)
    e_pad = u.shape[0]
    contrib_uv = contrib[s_inv]
    cu, cv = contrib_uv[:e_pad], contrib_uv[e_pad:]
    me = cu + cv

    # step 2: auction
    tie = hash01(torch.arange(e_pad, dtype=i32, device=dev)[:, None],
                 part_ids[None, :], rounds, dtype)
    score = me.to(dtype) + tie
    best = torch.argmax(score, dim=1)
    best_amt = torch.gather(me, 1, best[:, None])[:, 0]
    best = best.to(i32)
    paid = free & (best_amt >= 1) & emask
    new_owner = torch.where(paid, best, owner)
    now_owned = new_owner[:, None] == part_ids[None, :]
    residual = me - (paid[:, None] & now_owned).to(i32)
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
    mv_new = mv_left.clone()
    mv_new.index_add_(0, u, ref_u)
    mv_new.index_add_(0, v, ref_v)

    # step 3: grants min(cap, ceil(|E| / size)) over the frontier
    sz = sizes(new_owner, k)
    still_free = new_owner == FREE
    grant = torch.clamp((n_edges + sz.clamp(min=1) - 1) // sz.clamp(min=1),
                        max=cap)
    grant = torch.where(still_free.sum() > 0, grant, 0).to(i32)
    fr_u = (scatter_any(n_vertices, u, (cu > 0) & still_free[:, None])
            | scatter_any(n_vertices, v, (cv > 0) & still_free[:, None]))
    owned_mask = now_owned & emask[:, None]
    owned_at = (scatter_any(n_vertices, u, owned_mask)
                | scatter_any(n_vertices, v, owned_mask))
    presence = (mv_new > 0) | owned_at
    presence = torch.where(fr_u.any(dim=0)[None, :], fr_u, presence)
    pres_i = presence.to(i32)
    n_pres = pres_i.sum(dim=0, dtype=i32).clamp(min=1)
    p_base = grant // n_pres
    p_rem = grant - p_base * n_pres
    p_rank = cumsum_rows(pres_i) - pres_i
    seven = torch.full((1,), 7, dtype=i32, device=dev)
    p_rot = (hash01(seven[:, None], part_ids[None, :], rounds, dtype)
             * n_pres.to(dtype)).to(i32)
    p_rank = (p_rank + p_rot) % n_pres[None, :]
    mv_new = mv_new + pres_i * (p_base[None, :]
                                + (p_rank < p_rem[None, :]).to(i32))
    return new_owner, mv_new, paid.any()


def finalize(n_vertices, src, dst, emask, owner, k, iters=64):
    """Leftover free edges to the least-loaded adjacent partition."""
    inf = float("inf")
    own = owner
    for _ in range(iters):
        sz = sizes(own, k).to(torch.float32)
        live = own >= 0
        own_c = own.clamp(min=0)
        score = torch.where(live, sz[own_c.to(torch.int64)], inf)
        enc = score * (k + 1) + own_c.to(torch.float32)
        enc = torch.where(live & emask, enc, inf)
        best = torch.full((n_vertices,), inf, dtype=torch.float32,
                          device=src.device)
        best.scatter_reduce_(0, src, enc, "amin")
        best.scatter_reduce_(0, dst, enc, "amin")
        cand_enc = torch.minimum(best[src], best[dst])
        finite = torch.isfinite(cand_enc)
        lab = torch.fmod(torch.where(finite, cand_enc, 0.0), k + 1)
        cand = torch.where(finite, lab.to(torch.int32), -1)
        own = torch.where((own == FREE) & (cand >= 0), cand, own)
    return torch.where(own == FREE, 0, own).to(torch.int32)


def partition(g: EdgeList, k: int, starts, *, cap: int = 10,
              max_rounds: int = 10_000, stall_rounds: int = 256,
              dtype: torch.dtype = torch.float32, device="cpu"
              ) -> tuple[np.ndarray, int]:
    """(owner [E_pad] int32 with -2 at padding, rounds run)."""
    starts = [int(s) for s in np.asarray(starts).reshape(-1)]
    if len(starts) != k or len(set(starts)) != k:
        raise ValueError(f"starts must be {k} distinct vertex ids")
    u = torch.from_numpy(np.asarray(g.src, np.int64)).to(device)
    v = torch.from_numpy(np.asarray(g.dst, np.int64)).to(device)
    emask = torch.from_numpy(np.asarray(g.mask, bool)).to(device)
    n_edges = g.n_edges
    slots = build_slots(g, device)
    mv = torch.zeros((g.n_vertices, k), dtype=torch.int32, device=device)
    mv[torch.tensor(starts, device=device),
       torch.arange(k, device=device)] = -(-n_edges // k)
    owner = torch.where(emask, FREE, -2).to(torch.int32)
    rounds = stalled = 0
    while (bool((owner == FREE).any()) and rounds < max_rounds
           and stalled < stall_rounds):
        owner, mv, progressed = dfep_round(
            g.n_vertices, n_edges, u, v, emask, slots, k, cap, owner, mv,
            torch.tensor(rounds, dtype=torch.int32, device=device), dtype)
        rounds += 1
        stalled = 0 if bool(progressed) else stalled + 1
    if bool((owner == FREE).any()):
        owner = finalize(g.n_vertices, u, v, emask, owner, k)
    owner = torch.where(emask, owner, -2).to(torch.int32)
    return owner.cpu().numpy(), rounds

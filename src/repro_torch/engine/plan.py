"""Compile a Graph + edge-partition assignment into an executable plan.

Counterpart of ``repro.engine.plan``: the same host-side numpy compilation
(bucket, compact, CSR-sort, pad), the same 6 static and 16 tensor fields
with the same values and dtypes, placed on one device:

  * each partition i gets a local id space ``0 .. n_local[i]`` over the
    endpoints of its owned edges (``local2global`` maps back),
  * owned undirected edges are expanded to two directed half-edges and laid
    out in CSR order by target local id — the layout the segment-reduce
    kernel (``engine/kernels.py``) walks,
  * the replica-exchange plan records which local slots are replicas of a
    vertex that also lives in other partitions (``replicated``), and which
    partition is the designated master (``is_master``, lowest partition id).

``v_max`` / ``e_max`` are the max over partitions, rounded up to 128 as in
the reference (so plans compare field for field), with at least one padding
slot in the edge stream that always holds the combine identity.

Slack: ``edge_slack`` / ``vertex_slack`` reserve per-partition capacity;
``csr_fill`` marks the end of the sorted CSR prefix, and ``[csr_fill,
e_max)`` is the unsorted append region, whose live slots the kernels
combine into each target after its run.

Index fields stay int32 like the reference's. The runtime needs int64
indices for gathers and scatters; :meth:`PartitionPlan.index64` widens a
field once per plan and keeps the result, as :attr:`PartitionPlan.run_start`
keeps each slot's run start for the layouts, and
``engine.kernels.segment_layout``, ``gspmm_layout`` and ``exchange_layout``
keep ``segment_reduce``'s, ``gspmm``'s and ``exchange``'s layouts (built
with the plan when the plan is made on the card, so no query pays them).

:func:`compile_plan_cached` memoizes plans by graph and assignment content
and by device, in a process-wide LRU of 32 (``plan_cache_stats``,
``plan_cache_clear``), as the reference does.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib

import numpy as np
import torch

from .. import obs as _obs
from ..core.graph import Graph, edge_weights, resolve_device
from .kernels import exchange_layout, gspmm_layout

#: The 16 tensor fields, in the reference's order.
TENSOR_FIELDS = ("local2global", "vmask", "edge_tgt", "edge_nbr", "emask",
                 "seg_start", "last_slot", "replicated", "is_master",
                 "n_local", "n_edges_local", "n_replicated", "csr_fill",
                 "v_fill", "edge_w", "edge_slot")
#: The 6 static fields.
STATIC_FIELDS = ("k", "n_vertices", "v_max", "e_max", "epoch", "e_slots")


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """Per-partition compacted CSR blocks + replica exchange plan."""

    # static
    k: int                   # number of partitions
    n_vertices: int          # global |V|
    v_max: int               # padded local-vertex capacity
    e_max: int               # padded directed-half-edge capacity (>= 1 pad slot)
    epoch: int               # compaction epoch; bumps only on full recompile
    e_slots: int             # Graph.e_pad the plan was compiled against

    # local vertex space
    local2global: torch.Tensor  # [K, Vmax] int32 — global id per local slot (pad: 0)
    vmask: torch.Tensor         # [K, Vmax] bool  — slot holds a real vertex
    # CSR half-edge stream, sorted by target local id in [0, csr_fill);
    # [csr_fill, e_max) is the append/slack region
    edge_tgt: torch.Tensor      # [K, Emax] int32 — target local id
    edge_nbr: torch.Tensor      # [K, Emax] int32 — neighbour local id
    emask: torch.Tensor         # [K, Emax] bool  — real half-edge
    seg_start: torch.Tensor     # [K, Emax] bool  — first half-edge of its target
    last_slot: torch.Tensor     # [K, Vmax] int32 — last CSR slot per target
                                #   (pad vertices -> a pad slot holding identity)
    # replica exchange plan
    replicated: torch.Tensor    # [K, Vmax] bool — vertex also lives elsewhere
    is_master: torch.Tensor     # [K, Vmax] bool — this partition owns the vertex
    n_local: torch.Tensor       # [K] int32 — real local vertices per partition
    n_edges_local: torch.Tensor # [K] int32 — real owned (undirected) edges
    n_replicated: torch.Tensor  # [K] int32 — replicated slots per partition
    csr_fill: torch.Tensor      # [K] int32 — first slot of the append region
    v_fill: torch.Tensor        # [K] int32 — next free local-vertex slot
    edge_w: torch.Tensor        # [K, Emax] float32 — content-hash weights (pad 1.0)
    edge_slot: torch.Tensor     # [K, Emax] int32 — graph edge slot (-1 at pad)

    @property
    def device(self) -> torch.device:
        return self.local2global.device

    def _memo(self, key: str, make):
        """Per-instance memo (the plan is immutable): host sums and widened
        indices are computed once per plan."""
        cached = self.__dict__.get(key)
        if cached is None:
            cached = make()
            object.__setattr__(self, key, cached)
        return cached

    def index64(self, name: str) -> torch.Tensor:
        """An int32 index field widened once to int64 (gathers and
        scatters take int64 indices)."""
        return self._memo(f"_i64_{name}", lambda: getattr(self, name).long())

    # -- replica-exchange accounting ----------------------------------------
    @property
    def exchange_volume(self) -> int:
        """Vertex states crossing the cut per superstep: Σ|F_i| (MESSAGES)."""
        return self._memo("_exchange_volume",
                          lambda: int(self.n_replicated.sum()))

    @property
    def sum_local_vertices(self) -> int:
        return self._memo("_sum_local_vertices",
                          lambda: int(self.n_local.sum()))

    @property
    def edge_slot_hwm(self) -> int:
        """1 + the highest graph edge slot any live half-edge references —
        the least row count an edge channel plane must supply (one host
        read per plan instance)."""
        return self._memo("_edge_slot_hwm", lambda: int(
            torch.where(self.emask, self.edge_slot, -1).max()) + 1)

    @property
    def run_start(self) -> torch.Tensor:
        """[K, Emax] int32: the nearest slot at or before each slot with
        ``seg_start`` set (0 if none), i.e. where the run through that slot
        begins: a target's run is ``[run_start[last_slot], last_slot]``,
        which the kernels' layout is built from."""
        def make():
            slot = torch.arange(self.e_max, dtype=torch.int32,
                                device=self.device)
            return torch.where(self.seg_start, slot, 0).cummax(dim=1) \
                .values.contiguous()
        return self._memo("_run_start", make)

    def exchange_per_superstep(self) -> int:
        return self.exchange_volume

    def replication_factor(self) -> float:
        """Σ|V_i| / |V| — the paper's replication factor."""
        return self.sum_local_vertices / max(self.n_vertices, 1)

    def local_edges(self) -> list[np.ndarray]:
        """Per-partition [e_i, 2] arrays of owned undirected edges (global
        ids, u < v)."""
        l2g = self.local2global.cpu().numpy()
        tgt = self.edge_tgt.cpu().numpy()
        nbr = self.edge_nbr.cpu().numpy()
        em = self.emask.cpu().numpy()
        out = []
        for i in range(self.k):
            t = l2g[i, tgt[i, em[i]]]
            n = l2g[i, nbr[i, em[i]]]
            u, v = np.minimum(t, n), np.maximum(t, n)
            # every undirected edge appears as two half-edges
            out.append(np.unique(np.stack([u, v], 1), axis=0))
        return out


def _align(x: int, to: int = 128) -> int:
    return max(to, -(-x // to) * to)


def replica_masks(l2g: np.ndarray, vmask: np.ndarray, n_vertices: int,
                  k: int) -> tuple[np.ndarray, np.ndarray]:
    """(replicated, is_master) recomputed from scratch."""
    copies = np.zeros(n_vertices, np.int32)
    master_of = np.full(n_vertices, -1, np.int32)
    for i in reversed(range(k)):                # lowest partition id wins
        present = l2g[i, vmask[i]]
        master_of[present] = i
    for i in range(k):
        copies[l2g[i, vmask[i]]] += 1
    replicated = vmask & (copies[l2g] >= 2)
    is_master = vmask & (master_of[l2g] == np.arange(k)[:, None])
    return replicated, is_master


def _to_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


def compile_plan(g: Graph, owner, k: int, *, edge_slack: int = 0,
                 vertex_slack: int = 0, epoch: int = 0,
                 device=None) -> PartitionPlan:
    """Host-side compilation (numpy): bucket, compact, CSR-sort, pad; the
    tensors are then placed on ``device`` (``None``: ``cuda``).

    ``edge_slack`` / ``vertex_slack`` reserve per-partition capacity (in
    undirected edges / local vertices) for a streaming patch path.
    """
    dev = resolve_device(device)
    owner = _to_numpy(owner)
    u = g.src.cpu().numpy()
    v = g.dst.cpu().numpy()
    em = g.edge_mask.cpu().numpy()
    gslot = np.flatnonzero(em).astype(np.int32)   # graph slot per live edge
    u, v, owner = u[em], v[em], owner[em]
    if len(u) and (owner.min() < 0 or owner.max() >= k):
        raise ValueError("owner must assign every real edge to [0, k)")

    # per-partition compacted vertex sets ---------------------------------
    locals_: list[np.ndarray] = []
    for i in range(k):
        sel = owner == i
        locals_.append(np.unique(np.concatenate([u[sel], v[sel]])))
    n_local = np.array([len(x) for x in locals_], np.int32)
    e_cnt = np.array([int((owner == i).sum()) for i in range(k)], np.int32)
    v_max = _align(int(n_local.max(initial=1)) + int(vertex_slack))
    # 2 half-edges per owned edge; +1 guarantees a padding slot for last_slot
    e_max = _align(int(2 * e_cnt.max(initial=1)) + 1 + 2 * int(edge_slack))

    l2g = np.zeros((k, v_max), np.int32)
    vmask = np.zeros((k, v_max), bool)
    tgt = np.zeros((k, e_max), np.int32)
    nbr = np.zeros((k, e_max), np.int32)
    emask_p = np.zeros((k, e_max), bool)
    seg_start = np.zeros((k, e_max), bool)
    ew = np.ones((k, e_max), np.float32)
    eslot = np.full((k, e_max), -1, np.int32)
    # degree-0/pad vertices point at the last slot, which is always padding
    last_slot = np.full((k, v_max), e_max - 1, np.int32)

    for i in range(k):
        verts = locals_[i]
        nl = len(verts)
        l2g[i, :nl] = verts
        vmask[i, :nl] = True
        sel = owner == i
        g2l = np.zeros(g.n_vertices, np.int64)
        g2l[verts] = np.arange(nl)
        ut, vt = g2l[u[sel]], g2l[v[sel]]
        t = np.concatenate([ut, vt])            # half-edge targets
        n = np.concatenate([vt, ut])            # half-edge sources
        w2 = np.tile(edge_weights(u[sel], v[sel]), 2)   # both half-edges
        s2 = np.tile(gslot[sel], 2)             # graph slot, both half-edges
        order = np.argsort(t, kind="stable")
        t, n, w2, s2 = t[order], n[order], w2[order], s2[order]
        ne = len(t)
        tgt[i, :ne] = t
        nbr[i, :ne] = n
        ew[i, :ne] = w2
        eslot[i, :ne] = s2
        emask_p[i, :ne] = True
        if ne:
            seg_start[i, 0] = True
            seg_start[i, 1:ne] = t[1:] != t[:-1]
            # last slot of each target's run
            is_last = np.ones(ne, bool)
            is_last[:-1] = t[1:] != t[:-1]
            last_slot[i, t[is_last]] = np.flatnonzero(is_last)
        # padding region starts a fresh (identity-valued) segment
        if ne < e_max:
            seg_start[i, ne] = True

    replicated, is_master = replica_masks(l2g, vmask, g.n_vertices, k)
    return plan_from_numpy(
        dict(k=int(k), n_vertices=int(g.n_vertices), v_max=int(v_max),
             e_max=int(e_max), epoch=int(epoch), e_slots=int(g.e_pad),
             local2global=l2g, vmask=vmask, edge_tgt=tgt, edge_nbr=nbr,
             emask=emask_p, seg_start=seg_start, last_slot=last_slot,
             replicated=replicated, is_master=is_master, n_local=n_local,
             n_edges_local=e_cnt,
             n_replicated=replicated.sum(1).astype(np.int32),
             csr_fill=2 * e_cnt, v_fill=n_local, edge_w=ew,
             edge_slot=eslot),
        device=dev)


def plan_from_numpy(ref, device=None) -> PartitionPlan:
    """Build a plan from the 22 fields, given as a mapping or as attributes
    of any object (e.g. a reference ``repro.engine.plan.PartitionPlan``);
    arrays are anything ``np.asarray`` converts. On the card the plan's
    ``segment_reduce``, ``gspmm`` and ``exchange`` layouts are built here
    too."""
    dev = resolve_device(device)

    def get(name):
        return ref[name] if isinstance(ref, dict) else getattr(ref, name)

    static = {f: int(get(f)) for f in STATIC_FIELDS}
    tensors = {f: torch.from_numpy(np.array(get(f))).to(dev)
               for f in TENSOR_FIELDS}
    plan = PartitionPlan(**static, **tensors)
    if plan.device.type == "cuda":
        gspmm_layout(plan)          # and, under it, segment_layout(plan)
        exchange_layout(plan)
    return plan


# ---------------------------------------------------------------------------
# Content-addressed plan cache: keyed by Graph.fingerprint() + assignment
# digest, NOT object identity — logically equal (graph, owner, k) triples
# share one compiled plan even across Graph/owner array rebuilds. The key
# also holds the device: a plan on the card is never handed to a caller
# that asked for the CPU, nor the reverse.
# ---------------------------------------------------------------------------

_PLAN_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_PLAN_CACHE_MAX = 32    # LRU bound: plans are multi-MB of device tensors
# hits mean a query re-used an already-compiled plan; a climbing eviction
# count under steady load means the working set exceeds _PLAN_CACHE_MAX
_PLAN_CACHE_COUNTERS = {"hits": 0, "misses": 0, "evictions": 0}


def _owner_digest(g: Graph, owner) -> str:
    """Digest of the assignment in canonical (sorted-edge-key) order, so the
    key is invariant under slot permutation, like Graph.fingerprint()."""
    u, v = g.as_numpy()
    own = _to_numpy(owner)[g.edge_mask.cpu().numpy()].astype(np.int32)
    order = np.argsort(u.astype(np.int64) * g.n_vertices + v)
    return hashlib.sha256(own[order].tobytes()).hexdigest()


def compile_plan_cached(g: Graph, owner, k: int, *, edge_slack: int = 0,
                        vertex_slack: int = 0, epoch: int = 0,
                        device=None) -> PartitionPlan:
    """Memoized :func:`compile_plan`, keyed by graph/assignment *content*
    and the device. A hit returns the same plan object, its kernels'
    layouts already built (on the card ``compile_plan`` builds them).

    Caveat for edge property channels: the key is slot-order invariant but
    ``plan.edge_slot`` is not, so two content-equal graphs whose live
    edges occupy different slots would read an [E_pad, F] plane
    differently; use this entry point for static graphs (where slot order
    is canonical) or vertex-channel / channel-free workloads.
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (g.fingerprint(), _owner_digest(g, owner), int(k),
           int(edge_slack), int(vertex_slack), int(epoch), str(dev))
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        _PLAN_CACHE_COUNTERS["misses"] += 1
        plan = compile_plan(g, owner, k, edge_slack=edge_slack,
                            vertex_slack=vertex_slack, epoch=epoch,
                            device=dev)
        _PLAN_CACHE[key] = plan
        while len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
            _PLAN_CACHE.popitem(last=False)
            _PLAN_CACHE_COUNTERS["evictions"] += 1
    else:
        _PLAN_CACHE_COUNTERS["hits"] += 1
        _PLAN_CACHE.move_to_end(key)
    return plan


def plan_cache_stats() -> dict:
    """Snapshot of the plan cache's hit/miss/eviction counters + size."""
    return dict(_PLAN_CACHE_COUNTERS, size=len(_PLAN_CACHE),
                max_size=_PLAN_CACHE_MAX)


_obs.get().register_provider("plan_cache", plan_cache_stats)


def plan_cache_clear(reset_counters: bool = False) -> None:
    _PLAN_CACHE.clear()
    if reset_counters:
        for name in _PLAN_CACHE_COUNTERS:
            _PLAN_CACHE_COUNTERS[name] = 0

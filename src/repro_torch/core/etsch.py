"""ETSCH — the paper's edge-partition graph-processing framework (§III), in
PyTorch.

Counterpart of ``repro.core.etsch``. Computation model (Fig. 2):

  1. *init*        — per-vertex state initialised on each induced subgraph,
  2. *local phase* — each partition independently runs a sequential algorithm
                     on its subgraph to a local fixed point,
  3. *aggregation* — replicated (frontier) vertex states are reconciled with
                     a commutative/associative reducer and copied back.

Steps 2–3 repeat ("supersteps") until a global fixed point. The number of
supersteps is the paper's *rounds* metric; the fraction saved against a
vertex-centric (one hop per round) execution is its *gain*.

State is a dense [K, V] matrix of partition-local vertex copies; non-member
entries hold the reducer's identity. The local phase is masked relaxation
sweeps: :func:`min_relax_sweep` runs ``kernels.ops.minplus_sweep`` on the
flattened [K·V] state (indices ``k·V + src`` and the kernel's
target-sorted layout, derived once per :class:`Partitioning`). The min
aggregation of SSSP and CC is ``kernels.ops.frontier_min`` over the
member mask, which equals the
reference's plain axis-0 min because every non-member entry holds
``+inf``. The reference's ``lax.while_loop``s are Python loops here: each
fixed-point test is one device→host read per local sweep and per
superstep.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..kernels import ops
from .graph import Graph, resolve_device


@dataclasses.dataclass(frozen=True)
class Partitioning:
    """An edge partitioning compiled into static per-partition tensors."""

    k: int                  # static
    n_vertices: int         # static
    e_max: int              # static: padded per-partition edge capacity
    src: torch.Tensor       # [K, E_max] int32 (padding: 0, masked)
    dst: torch.Tensor       # [K, E_max] int32
    mask: torch.Tensor      # [K, E_max] bool
    member: torch.Tensor    # [K, V] bool — v ∈ V_i
    frontier: torch.Tensor  # [K, V] bool — v ∈ F_i (in ≥ 2 partitions)

    @property
    def device(self) -> torch.device:
        return self.src.device

    @property
    def sizes(self) -> torch.Tensor:
        return self.mask.sum(dim=1, dtype=torch.int32)

    def _memo(self, key: str, make):
        """Per-instance memo (the partitioning is immutable)."""
        cached = self.__dict__.get(key)
        if cached is None:
            cached = make()
            object.__setattr__(self, key, cached)
        return cached

    def _flat(self, name: str) -> torch.Tensor:
        """[K·E_max] int32 indices ``k·V + field`` into the flattened [K·V]
        state, derived once per instance."""
        def make():
            base = torch.arange(self.k, dtype=torch.int32,
                                device=self.device)[:, None] * self.n_vertices
            return (base + getattr(self, name)).reshape(-1).contiguous()
        return self._memo(f"_flat_{name}", make)

    @property
    def flat_src(self) -> torch.Tensor:
        return self._flat("src")

    @property
    def flat_dst(self) -> torch.Tensor:
        return self._flat("dst")

    @property
    def flat_mask(self) -> torch.Tensor:
        return self.mask.reshape(-1)

    @property
    def minplus_layout(self) -> ops.MinplusLayout:
        """``minplus_sweep``'s target-sorted layout of the flat edges over
        the [K·V] state, one group per partition, built once."""
        return self._memo("_minplus_layout", lambda: ops.minplus_layout(
            self.flat_src, self.flat_dst, self.k * self.n_vertices,
            groups=self.k))

    @classmethod
    def from_reference(cls, part, device=None) -> "Partitioning":
        """Port a ``repro.core.etsch.Partitioning`` (or any object with its
        fields, arrays convertible by ``np.asarray``) to ``device``
        (``None``: ``cuda``)."""
        dev = resolve_device(device)

        def t(a, dtype):
            return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)

        return cls(int(part.k), int(part.n_vertices), int(part.e_max),
                   t(part.src, np.int32), t(part.dst, np.int32),
                   t(part.mask, bool), t(part.member, bool),
                   t(part.frontier, bool))


def compile_partitioning(g: Graph, owner, k: int, e_max: int | None = None,
                         device=None) -> Partitioning:
    """Host-side (numpy): bucket edges by owner into padded [K, E_max]
    arrays, then place them on ``device`` (``None``: ``cuda``)."""
    dev = resolve_device(device)
    if isinstance(owner, torch.Tensor):
        owner = owner.cpu().numpy()
    owner = np.asarray(owner)
    u = g.src.cpu().numpy()
    v = g.dst.cpu().numpy()
    emask = g.edge_mask.cpu().numpy()
    u, v, owner = u[emask], v[emask], owner[emask]
    if len(owner) and (owner.min() < 0 or owner.max() >= k):
        raise ValueError("owner must assign every real edge to [0, k)")

    counts = np.bincount(owner, minlength=k)
    if e_max is None:
        e_max = max(int(counts.max()) if len(owner) else 0, 1)
        e_max = -(-e_max // 128) * 128  # lane-align, as the reference
    ps = np.zeros((k, e_max), np.int32)
    pd = np.zeros((k, e_max), np.int32)
    pm = np.zeros((k, e_max), bool)
    order = np.argsort(owner, kind="stable")
    so, su_, sv_ = owner[order], u[order], v[order]
    group_start = np.searchsorted(so, np.arange(k))
    pos = np.arange(len(so)) - group_start[so]
    ps[so, pos] = su_
    pd[so, pos] = sv_
    pm[so, pos] = True

    member = np.zeros((k, g.n_vertices), bool)
    rows = np.repeat(np.arange(k)[:, None], e_max, 1)
    member[rows[pm], ps[pm]] = True
    member[rows[pm], pd[pm]] = True
    replicas = member.sum(0)
    frontier = member & (replicas[None, :] >= 2)

    def t(a):
        return torch.from_numpy(a).to(dev)

    return Partitioning(k, g.n_vertices, e_max, t(ps), t(pd), t(pm),
                        t(member), t(frontier))


# ---------------------------------------------------------------------------
# Generic superstep engine
# ---------------------------------------------------------------------------

class Problem(NamedTuple):
    """An ETSCH problem: init / local one-sweep relaxation / aggregation.

    ``local_sweep(p, state) -> state`` performs ONE edge-relaxation sweep of
    the partition-local sequential algorithm; the engine iterates it to the
    local fixed point (that iteration is *free* in the paper's cost model —
    it happens inside a worker between synchronisations).

    ``reduce(p, state) -> [V]`` must be commutative/associative with
    identity ``identity``; unlike the reference's it is also handed the
    partitioning, so that a min reduce can run ``frontier_min`` over the
    member mask.
    ``mode`` = "replica"  → replicas hold copies of one logical value; the
                            aggregate replaces every replica (min/max style).
             = "partial"  → replicas hold *partial* values that must be
                            summed across partitions (PageRank style).
    """
    init: Callable          # (part, **kw) -> [K, V] state
    local_sweep: Callable   # (part, [K, V]) -> [K, V]
    reduce: Callable        # (part, [K, V]) -> [V]
    identity: float
    mode: str = "replica"


class EtschResult(NamedTuple):
    state: torch.Tensor     # [V] final aggregated vertex state
    supersteps: int         # the paper's "rounds"
    local_iters: int        # total local sweeps executed


def _local_fixed_point(part: Partitioning, prob: Problem, state,
                       max_iters: int):
    """Iterate local sweeps until no partition changes (bounded)."""
    st, iters, changed = state, 0, True
    while changed and iters < max_iters:
        new = prob.local_sweep(part, st)
        changed = bool((new != st).any())
        st, iters = new, iters + 1
    return st, iters


def run_etsch(part: Partitioning, prob: Problem,
              max_supersteps: int = 512, max_local_iters: int = 100_000,
              **init_kw) -> EtschResult:
    st = prob.init(part, **init_kw)
    steps, litot, changed = 0, 0, True
    while changed and steps < max_supersteps:
        st1, li = _local_fixed_point(part, prob, st, max_local_iters)
        red = prob.reduce(part, st1)                            # [V]
        st2 = torch.where(part.member, red[None, :], prob.identity)
        changed = bool((st2 != st).any())
        st, steps, litot = st2, steps + 1, litot + li
    return EtschResult(prob.reduce(part, st), steps, litot)


# ---------------------------------------------------------------------------
# Relaxation helpers shared by the concrete problems (algorithms.py)
# ---------------------------------------------------------------------------

def min_relax_sweep(part: Partitioning, state: torch.Tensor,
                    edge_cost: float = 1.0) -> torch.Tensor:
    """One min-plus sweep over every partition's edges simultaneously.

    state [K, V] float32; for every partition-k edge (u,v):
        state[k, v] <- min(state[k, v], state[k, u] + cost)   (both directions)
    as one ``minplus_sweep`` over the flattened [K·V] state.
    """
    k, v_n = state.shape
    out = ops.minplus_sweep(state.reshape(-1), part.flat_src, part.flat_dst,
                            part.flat_mask, edge_cost,
                            layout=part.minplus_layout)
    return out.view(k, v_n)

"""Edge-centric superstep runtime over a ``PartitionPlan`` (PyTorch).

Counterpart of ``repro.engine.runtime`` on one device. Execution model
(paper §III, compacted):

  1. *local phase* — every partition runs Gather-Apply sweeps over its own
     CSR block (gather neighbour values along half-edges, segment-reduce per
     target, apply) — to a local fixed point for min-style programs, exactly
     one sweep for partial-aggregation programs (PageRank);
  2. *replica exchange* — each vertex's ``plan.replicated`` slots are
     combined across partitions (min for replica state, add for partial
     aggregates) and the result written back to each: one
     ``kernels.exchange`` launch over the plan's replica layout, where the
     reference scatters into a global frontier array and gathers it back.

Steps 1–2 repeat until the exchanged state reaches a global fixed point
(or for a fixed number of supersteps). ``supersteps`` is the paper's
*rounds* metric; the exchanged-slot count per superstep is its MESSAGES.

The reference's ``lax.while_loop``s become Python loops: each fixed-point
test (``any(new != old)``) is one device→host read. ``Engine(plan,
use_kernels=True)`` sweeps and exchanges through the kernels of
``engine/kernels.py`` (their plain versions for CPU tensors);
``use_kernels=False`` runs the plain versions everywhere, as the
reference's XLA path does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from . import kernels
from .errors import WarmStateError
from .plan import PartitionPlan
from .state import SCALAR, StateSpec


class EdgeProgram(NamedTuple):
    """A "think-like-an-edge" program. All callables take and return
    tensors; per-query values travel in the ``ctx`` dict.

    mode "replica": state slots are replicas of one logical per-vertex value
                    (combine = min); ``apply`` runs inside the local sweep.
    mode "partial": local sweeps produce partial aggregates that sum across
                    partitions (combine = add); ``apply`` runs after the
                    exchange completes the aggregate.

    With the default scalar ``state`` spec every hook sees/returns
    [K, Vmax] blocks and the finalized result is [V]; with
    ``StateSpec(features=F)`` the hooks carry [K, Vmax, F] planes.
    """
    name: str
    mode: str                       # "replica" | "partial"
    combine: str                    # "min" | "add" | "max"
    prepare: Callable               # (plan, kw) -> ctx dict (once per query)
    init: Callable                  # (plan, ctx) -> [K, Vmax(, F)] state
    pre: Callable                   # (state, ctx) -> per-vertex msg values
    apply: Callable                 # (old, agg, ctx) -> new
    finalize: Callable              # (glob [V(, F)], present [V], plan, ctx)
                                    #   -> [V(, F)]
    local_fixpoint: bool = True
    default_supersteps: int | None = None   # None -> run to fixed point
    edge: Callable | None = None    # (msgs [K, Emax(, F)], plan, ctx) -> msgs
                                    #   — per-half-edge transform applied
                                    #   after the neighbour gather
    warm_init: Callable | None = None
                                    # (plan, prev [V(, F)], ctx) ->
                                    #   [K, Vmax(, F)] warm-start state
    edge_mul: Callable | None = None
                                    # (plan, ctx) -> [K, Emax] or [K, Emax, F]
                                    #   multiplicative per-half-edge weights;
                                    #   routes the sweep through gspmm
                                    #   (gather · multiply · segment-reduce
                                    #   in one kernel) instead of the edge
                                    #   hook and segment_reduce
    state: StateSpec = SCALAR       # per-vertex state shape declaration


@dataclasses.dataclass(frozen=True)
class EngineResult:
    state: torch.Tensor             # [V(, F)] global vertex state
    supersteps: int                 # the paper's "rounds"
    local_iters: int                # local sweeps on the critical path
    converged: bool                 # False iff the superstep cap was hit
                                    #   first (state is then a truncation)
    exchange_per_superstep: int     # replica slots crossing the cut per round
    total_exchanged: int            # supersteps * exchange_per_superstep

    def row(self) -> dict:
        return {"supersteps": self.supersteps,
                "local_iters": self.local_iters,
                "converged": self.converged,
                "exchange_per_superstep": self.exchange_per_superstep,
                "total_exchanged": self.total_exchanged}


@dataclasses.dataclass(frozen=True)
class PendingResult:
    """Handle returned by :meth:`Engine.dispatch`. The superstep loop's
    fixed-point tests read the device, so the query has finished when
    ``dispatch`` returns; ``result()`` hands the ``EngineResult`` over."""
    _result: EngineResult

    def result(self) -> EngineResult:
        return self._result


def _steps(prog: EdgeProgram, max_supersteps: int | None) -> int:
    if max_supersteps is not None:    # an explicit 0 means zero supersteps
        return max_supersteps
    if prog.default_supersteps is not None:
        return prog.default_supersteps
    return 512


def _expand(mask: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Broadcast a [K, Vmax] mask against scalar or feature-plane state."""
    return mask[:, :, None] if ref.ndim == 3 else mask


def _sweep(plan: PartitionPlan, prog: EdgeProgram, state, ctx, *,
           use_kernels: bool):
    """One Gather-Apply sweep: per-target aggregate [K, Vmax(, F)]."""
    pre = prog.pre(state, ctx)                              # [K, Vmax(, F)]
    if prog.edge_mul is not None:   # gSpMM path (GNN programs)
        w = prog.edge_mul(plan, ctx)
        spmm = kernels.gspmm if use_kernels else kernels.gspmm_ref
        agg = spmm(plan, pre, w, prog.combine)              # [K, Vmax, F]
        return agg[:, :, 0] if pre.ndim == 2 else agg
    rows = torch.arange(plan.k, device=pre.device)[:, None]
    msgs = pre[rows, plan.index64("edge_nbr")]              # [K, Emax(, F)]
    if prog.edge is not None:   # per-half-edge hook (weighted programs)
        msgs = prog.edge(msgs, plan, ctx)
    if use_kernels:
        return kernels.segment_reduce(plan, msgs, prog.combine)
    return kernels.segment_reduce_ref(plan, msgs, prog.combine)


def _exchange(plan: PartitionPlan, values, combine: str, *,
              use_kernels: bool):
    """Combine replicated slots across partitions; private slots unchanged.

    values [K, Vmax(, F)] -> same shape. With ``use_kernels`` one launch
    over the plan's replica layout (``kernels.exchange``); else the
    reference's scatter-and-gather chain (``kernels.exchange_ref``).
    """
    if use_kernels:
        return kernels.exchange(plan, values, combine)
    return kernels.exchange_ref(plan, values, combine)


def _gather_global(plan: PartitionPlan, state):
    """Master-slot scatter of the final local states to a global [V(, F)]."""
    tail = tuple(state.shape[2:])
    idx = plan.index64("local2global").reshape(-1)
    out = torch.zeros((plan.n_vertices,) + tail, dtype=torch.float32,
                      device=state.device)
    out.index_add_(0, idx, torch.where(_expand(plan.is_master, state),
                                       state, 0.0).reshape((-1,) + tail))
    present = torch.zeros(plan.n_vertices, dtype=torch.int32,
                          device=state.device)
    present.index_add_(0, idx, plan.is_master.reshape(-1).to(torch.int32))
    return out, present > 0


def _run_loop(plan: PartitionPlan, prog: EdgeProgram, kw: dict,
              prev: torch.Tensor | None, max_supersteps: int,
              max_local_iters: int, use_kernels: bool):
    """The superstep loop. Returns (state, supersteps, local_iters,
    converged)."""
    ctx = prog.prepare(plan, kw)
    state0 = prog.init(plan, ctx) if prev is None \
        else prog.warm_init(plan, prev, ctx)

    if prog.mode == "replica":
        def local_phase(st):
            def sweep(s):
                return prog.apply(s, _sweep(plan, prog, s, ctx,
                                            use_kernels=use_kernels), ctx)

            if not prog.local_fixpoint:   # exactly one sweep, uncapped
                return sweep(st), 1
            it, changed = 0, True
            while changed and it < max_local_iters:
                ns = sweep(st)
                it += 1
                changed = bool((ns != st).any())
                st = ns
            return st, it

        st, steps, litot, changed = state0, 0, 0, True
        while changed and steps < max_supersteps:
            st1, li = local_phase(st)
            st2 = _exchange(plan, st1, prog.combine, use_kernels=use_kernels)
            changed = bool((st2 != st).any())
            st, steps, litot = st2, steps + 1, litot + li
        converged = not changed   # still changing => the cap cut us off
    else:  # partial aggregation: lock-step, fixed superstep count
        st = state0
        for _ in range(max_supersteps):
            agg = _sweep(plan, prog, st, ctx, use_kernels=use_kernels)
            full = _exchange(plan, agg, prog.combine, use_kernels=use_kernels)
            st = prog.apply(st, full, ctx)
        steps = litot = max_supersteps
        converged = True          # fixed-iteration programs by design

    glob, present = _gather_global(plan, st)
    return prog.finalize(glob, present, plan, ctx), steps, litot, converged


@dataclasses.dataclass(frozen=True)
class Engine:
    """Partitioned execution engine bound to a plan, on the plan's device.

    ``use_kernels`` (default True) routes sweeps and exchanges through the
    Hopper kernels; False runs the plain PyTorch versions.
    """
    plan: PartitionPlan
    use_kernels: bool = True

    def _check_warm(self, prog: EdgeProgram, warm_state):
        """Validate a warm-start state: the program's finalized result
        shape, ``spec.shape(V)``; raises :class:`WarmStateError`."""
        if warm_state is None:
            return None
        if prog.warm_init is None:
            raise WarmStateError(
                f"program {prog.name!r} has no warm_init hook — pass "
                "warm_init= when constructing the EdgeProgram to enable "
                "warm-started dispatch, or drop warm_state")
        spec = prog.state
        prev = torch.as_tensor(warm_state, dtype=getattr(torch, spec.dtype),
                               device=self.plan.device)
        want = spec.shape(self.plan.n_vertices)
        if tuple(prev.shape) != want:
            raise WarmStateError(
                f"warm_state for program {prog.name!r} has shape "
                f"{tuple(prev.shape)} but the plan serves "
                f"{self.plan.n_vertices} vertices with per-vertex state "
                f"{spec.describe()} — expected {want} "
                "(the previous epoch's finalized result state)")
        return prev

    def dispatch(self, prog: EdgeProgram, max_supersteps: int | None = None,
                 max_local_iters: int = 100_000, warm_state=None,
                 **kw: Any) -> PendingResult:
        """Run one query; ``warm_state`` (a previous [V] result)
        initialises via ``prog.warm_init``."""
        steps = _steps(prog, max_supersteps)
        prev = self._check_warm(prog, warm_state)
        state, supersteps, litot, converged = _run_loop(
            self.plan, prog, kw, prev, steps, max_local_iters,
            self.use_kernels)
        ex = self.plan.exchange_volume
        return PendingResult(EngineResult(state, supersteps, litot,
                                          converged, ex, supersteps * ex))

    def run(self, prog: EdgeProgram, max_supersteps: int | None = None,
            max_local_iters: int = 100_000, warm_state=None,
            **kw: Any) -> EngineResult:
        return self.dispatch(prog, max_supersteps, max_local_iters,
                             warm_state=warm_state, **kw).result()

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

Batched queries (the serving scenario) answer S queries in one superstep
loop. Where the reference vmaps its whole loop, the port vmaps only the
program's per-lane hooks (``torch.func.vmap``) and lays the S lanes out
as a trailing axis, ``[K, Vmax, S(, F)]``: each sweep is one
``segment_reduce`` launch and each superstep one ``exchange`` launch at
F = S·F for the whole micro-batch. Per-lane masks on the device stop each
lane where its solo run would stop, so every lane's state and counters
are its solo run's.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, NamedTuple

import torch
from torch.func import vmap

from .. import obs as _obs
from . import kernels
from .errors import BatchAxisError, WarmStateError
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

    Hooks are written for one query. Batched dispatch maps them over its
    lanes with ``torch.func.vmap``, so there they must be tensor code: a
    per-lane value (e.g. a source vertex) arrives in ``kw`` as a 0-d
    tensor, and ``prepare`` returns a dict of tensors.
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
    state: torch.Tensor             # [V(, F)] global vertex state; batched:
                                    #   [S, V(, F)]
    supersteps: int | torch.Tensor  # the paper's "rounds"; batched: [S]
    local_iters: int | torch.Tensor # local sweeps on the critical path;
                                    #   batched: [S]
    converged: bool | torch.Tensor  # False iff the superstep cap was hit
                                    #   first (state is then a truncation);
                                    #   batched: [S]
    exchange_per_superstep: int     # replica slots crossing the cut per round
    total_exchanged: int            # supersteps * exchange_per_superstep
                                    #   (batched: the longest lane's)

    def row(self) -> dict:
        # batched runs carry per-lane vectors; report the critical path
        return {"supersteps": int(torch.as_tensor(self.supersteps).max()),
                "local_iters": int(torch.as_tensor(self.local_iters).max()),
                "converged": bool(torch.as_tensor(self.converged).all()),
                "exchange_per_superstep": self.exchange_per_superstep,
                "total_exchanged": self.total_exchanged}


@dataclasses.dataclass(frozen=True)
class PendingResult:
    """Handle returned by :meth:`Engine.dispatch` and
    :meth:`Engine.dispatch_batched`: the result's tensors and, on the card,
    a CUDA event recorded after the final gather and finalize.
    ``block_until_ready()`` waits for the event; ``result()`` waits, then
    hands the ``EngineResult`` over. The superstep loop reads the device
    once a sweep, so by the time ``dispatch`` returns only the finalize
    may still be running: the handle overlaps next to nothing with the
    caller's work."""
    _arrays: tuple                  # (state, supersteps, local_iters,
                                    #   converged)
    exchange_per_superstep: int
    _event: Any = None              # torch.cuda.Event, or None on the CPU

    def block_until_ready(self) -> "PendingResult":
        if self._event is not None:
            self._event.synchronize()
        return self

    def result(self) -> EngineResult:
        state, supersteps, local_iters, converged = \
            self.block_until_ready()._arrays
        ex = self.exchange_per_superstep
        steps = int(torch.as_tensor(supersteps).max())
        rec = _obs.get()
        if rec.enabled:   # per-dispatch superstep + exchange accounting
            rec.event("engine.result", supersteps=steps,
                      local_iters=int(torch.as_tensor(local_iters).max()),
                      converged=bool(torch.as_tensor(converged).all()),
                      exchange_per_superstep=ex, exchanged=steps * ex)
            rec.counter("engine.supersteps", steps)
            rec.counter("engine.exchanged", steps * ex)
        return EngineResult(state, supersteps, local_iters, converged, ex,
                            steps * ex)


def _pending(plan, out: tuple) -> PendingResult:
    """Wrap a loop's output, with an event recorded after its last op on
    the card."""
    event = None
    if out[0].device.type == "cuda":
        event = torch.cuda.Event()
        event.record()
    return PendingResult(out, plan.exchange_volume, event)


def _steps(prog: EdgeProgram, max_supersteps: int | None) -> int:
    if max_supersteps is not None:    # an explicit 0 means zero supersteps
        return max_supersteps
    if prog.default_supersteps is not None:
        return prog.default_supersteps
    return 512


def _expand(mask: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Broadcast a [K, Vmax] mask against scalar, feature-plane or batched
    [K, Vmax, *tail] state."""
    return mask.view(tuple(mask.shape) + (1,) * (ref.ndim - 2))


def _planes(fn, plan: PartitionPlan, x: torch.Tensor, combine: str):
    """``fn(plan, x, combine)`` for a kernel wrapper, with ``x``
    [K, N, *tail] laid out as the kernels take it: [K, N] or [K, N, F]
    with F contiguous. A batched state's tail (lanes, features) is
    flattened into F, which the kernels treat column by column, and
    restored on the result."""
    if x.ndim <= 3:
        return fn(plan, x.contiguous(), combine)
    k, tail = x.shape[0], tuple(x.shape[2:])
    out = fn(plan, x.reshape(k, x.shape[1], -1).contiguous(), combine)
    return out.view((k, out.shape[1]) + tail)


def _sweep(plan: PartitionPlan, prog: EdgeProgram, state, ctx, *,
           use_kernels: bool):
    """One Gather-Apply sweep: per-target aggregate [K, Vmax(, ...)]."""
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
    seg = kernels.segment_reduce if use_kernels \
        else kernels.segment_reduce_ref
    return _planes(seg, plan, msgs, prog.combine)


def _exchange(plan: PartitionPlan, values, combine: str, *,
              use_kernels: bool):
    """Combine replicated slots across partitions; private slots unchanged.

    values [K, Vmax(, ...)] -> same shape. With ``use_kernels`` one launch
    over the plan's replica layout (``kernels.exchange``); else the
    reference's scatter-and-gather chain (``kernels.exchange_ref``).
    """
    fn = kernels.exchange if use_kernels else kernels.exchange_ref
    return _planes(fn, plan, values, combine)


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


def _lane_program(prog: EdgeProgram, plan: PartitionPlan) -> EdgeProgram:
    """``prog`` with its per-sweep hooks mapped over a lane axis: state,
    aggregates and messages are [K, N, S(, F)] (lane axis 2, where the
    kernels want it), ``ctx`` has a leading lane axis."""
    edge = None
    if prog.edge is not None:
        lane_edge = vmap(lambda m, c: prog.edge(m, plan, c), in_dims=(2, 0),
                         out_dims=2)
        edge = lambda msgs, _plan, ctx: lane_edge(msgs, ctx)  # noqa: E731
    return prog._replace(
        pre=vmap(prog.pre, in_dims=(2, 0), out_dims=2),
        apply=vmap(prog.apply, in_dims=(2, 2, 0), out_dims=2), edge=edge)


def _run_lanes(plan: PartitionPlan, prog: EdgeProgram, kw: dict,
               batched_kw: dict, prev: torch.Tensor | None,
               max_supersteps: int, max_local_iters: int, use_kernels: bool):
    """The superstep loop for S lanes at once, each lane the query
    ``{**kw, **lane of batched_kw}``. Returns (state [S, V(, F)],
    supersteps [S], local_iters [S], converged [S]), each lane's equal to
    its solo :func:`_run_loop`.

    The lanes ride the state's axis 2 through one sweep and one exchange
    for all of them. A lane whose solo loop would have stopped keeps its
    state and counters: the masks ``active`` (superstep loop) and ``lact``
    (local phase) stay on the device, and each loop reads the device once
    a sweep and once a superstep, as the solo loop does.
    """
    n = int(next(iter(batched_kw.values())).shape[0])
    ctx = vmap(lambda b: prog.prepare(plan, {**kw, **b}))(batched_kw)
    if prev is None:
        st = vmap(lambda c: prog.init(plan, c), out_dims=2)(ctx)
    else:
        st = vmap(lambda pv, c: prog.warm_init(plan, pv, c),
                  out_dims=2)(prev, ctx)
    st = st.contiguous()                                # [K, Vmax, S(, F)]
    lane = _lane_program(prog, plan)
    dev = st.device

    def sweep(s):
        return lane.apply(s, _sweep(plan, lane, s, ctx,
                                    use_kernels=use_kernels), ctx)

    def where(mask, new, old):                          # mask [S]
        return torch.where(mask.view((n,) + (1,) * (new.ndim - 3)), new,
                           old)

    def differs(new, old):                              # -> [S]
        return (new != old).movedim(2, 0).reshape(n, -1).any(dim=1)

    def zeros():
        return torch.zeros(n, dtype=torch.int32, device=dev)

    if prog.mode == "replica":
        def local_phase(st, active):
            if not prog.local_fixpoint:   # exactly one sweep, uncapped
                return where(active, sweep(st), st), active.to(torch.int32)
            it, lact = zeros(), active
            go = max_local_iters > 0
            while go:
                ns = sweep(st)
                changed = differs(ns, st)
                st = where(lact, ns, st)
                it += lact
                lact = lact & changed & (it < max_local_iters)
                go = bool(lact.any())
            return st, it

        steps, litot = zeros(), zeros()
        active = torch.ones(n, dtype=torch.bool, device=dev)
        changed = active
        go = max_supersteps > 0
        while go:
            st1, li = local_phase(st, active)
            st2 = where(active, _exchange(plan, st1, prog.combine,
                                          use_kernels=use_kernels), st)
            changed = torch.where(active, differs(st2, st), changed)
            steps += active
            litot += li
            active = active & changed & (steps < max_supersteps)
            st = st2
            go = bool(active.any())
        converged = ~changed      # still changing => the cap cut it off
    else:  # partial aggregation: lock-step, fixed superstep count
        for _ in range(max_supersteps):
            agg = _sweep(plan, lane, st, ctx, use_kernels=use_kernels)
            full = _exchange(plan, agg, prog.combine,
                             use_kernels=use_kernels)
            st = lane.apply(st, full, ctx)
        steps = litot = torch.full((n,), max_supersteps, dtype=torch.int32,
                                   device=dev)
        converged = torch.ones(n, dtype=torch.bool, device=dev)

    glob, present = _gather_global(plan, st)            # [V, S(, F)]
    state = vmap(lambda g, c: prog.finalize(g, present, plan, c),
                 in_dims=(1, 0))(glob, ctx)
    return state.contiguous(), steps, litot, converged


@dataclasses.dataclass(frozen=True)
class Engine:
    """Partitioned execution engine bound to a plan, on the plan's device.

    ``use_kernels`` (default True) routes sweeps and exchanges through the
    Hopper kernels; False runs the plain PyTorch versions.
    """
    plan: PartitionPlan
    use_kernels: bool = True

    def with_plan(self, plan: PartitionPlan) -> "Engine":
        """Rebind to a (patched or recompiled) plan."""
        return dataclasses.replace(self, plan=plan)

    def _check_warm(self, prog: EdgeProgram, warm_state,
                    batch: int | None = None):
        """Validate a warm-start state (typed errors, actionable messages).

        A warm state is a previous epoch's *finalized* result in the
        program's declared state shape — ``spec.shape(V)``, or the batched
        ``spec.batch_shape(S, V)`` block with one row per lane; cold rows
        (``spec.fill``) mean "no prior information" and fall back to cold
        init. Raises :class:`WarmStateError`.
        """
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
        want = spec.shape(self.plan.n_vertices) if batch is None \
            else spec.batch_shape(batch, self.plan.n_vertices)
        if tuple(prev.shape) != want:
            raise WarmStateError(
                f"warm_state for program {prog.name!r} has shape "
                f"{tuple(prev.shape)} but the plan serves "
                f"{self.plan.n_vertices} vertices with per-vertex state "
                f"{spec.describe()} — expected {want} "
                "(the previous epoch's finalized result state)")
        return prev

    def _obs_dispatch(self, prog: EdgeProgram, bucket: int):
        """Per-dispatch telemetry: records the dispatch event (program,
        bucket, plan epoch, exchange volume, lane occupancy) and returns an
        ambient-tag context, so events recorded inside it are attributed
        to this program and bucket."""
        rec = _obs.get()
        if not rec.enabled:
            return contextlib.nullcontext()
        health = _obs.plan_health(self.plan)
        rec.event("engine.dispatch", program=prog.name, bucket=bucket,
                  epoch=self.plan.epoch, sharded=False,
                  exchange_per_superstep=health["exchange_per_superstep"],
                  edge_lane_occupancy_max=health["edge_lane_occupancy_max"],
                  vertex_lane_occupancy_max=
                      health["vertex_lane_occupancy_max"])
        rec.counter("engine.dispatches")
        for name, value in health.items():
            rec.gauge(f"plan.{name}", value)
        return rec.tags(program=prog.name, bucket=bucket)

    def dispatch(self, prog: EdgeProgram, max_supersteps: int | None = None,
                 max_local_iters: int = 100_000, warm_state=None,
                 **kw: Any) -> PendingResult:
        """Run one query; ``warm_state`` (a previous [V] result)
        initialises via ``prog.warm_init``."""
        steps = _steps(prog, max_supersteps)
        prev = self._check_warm(prog, warm_state)
        with self._obs_dispatch(prog, 0):
            out = _run_loop(self.plan, prog, kw, prev, steps,
                            max_local_iters, self.use_kernels)
        return _pending(self.plan, out)

    def run(self, prog: EdgeProgram, max_supersteps: int | None = None,
            max_local_iters: int = 100_000, warm_state=None,
            **kw: Any) -> EngineResult:
        return self.dispatch(prog, max_supersteps, max_local_iters,
                             warm_state=warm_state, **kw).result()

    def dispatch_batched(self, prog: EdgeProgram, batched_kw: dict,
                         max_supersteps: int | None = None,
                         max_local_iters: int = 100_000, warm_state=None,
                         **kw: Any) -> PendingResult:
        """Answer a micro-batch in one superstep loop: lane i is the query
        ``{**kw, name: batched_kw[name][i]}`` (e.g. ``{"source": sources}``
        for multi-source SSSP), and its state and counters equal that
        query's solo run. ``warm_state`` is a [S, V(, F)] block, one
        previous-result row per lane (rows of ``spec.fill`` cold-start
        their lane). Programs on the ``gspmm`` path (``edge_mul``) take no
        lanes: :class:`BatchAxisError`."""
        if prog.edge_mul is not None:
            raise BatchAxisError(
                f"program {prog.name!r} sweeps through gspmm (edge_mul), "
                "which carries no lane axis — dispatch its queries one at "
                "a time")
        steps = _steps(prog, max_supersteps)
        batched_kw = {name: torch.as_tensor(v, device=self.plan.device)
                      for name, v in batched_kw.items()}
        lanes = {int(v.shape[0]) if v.ndim else 0
                 for v in batched_kw.values()}
        if len(lanes) != 1 or min(lanes) < 1:
            raise BatchAxisError(
                f"batched_kw of program {prog.name!r} must hold arrays with "
                "one common, non-empty leading (lane) axis, got shapes "
                f"{ {k: tuple(v.shape) for k, v in batched_kw.items()} }")
        n_batch = lanes.pop()
        prev = self._check_warm(prog, warm_state, n_batch)
        with self._obs_dispatch(prog, n_batch):
            out = _run_lanes(self.plan, prog, kw, batched_kw, prev, steps,
                             max_local_iters, self.use_kernels)
        return _pending(self.plan, out)

    def run_batched(self, prog: EdgeProgram, batched_kw: dict,
                    max_supersteps: int | None = None,
                    max_local_iters: int = 100_000, warm_state=None,
                    **kw: Any) -> EngineResult:
        return self.dispatch_batched(prog, batched_kw, max_supersteps,
                                     max_local_iters, warm_state=warm_state,
                                     **kw).result()


_obs.get().register_provider("launches", lambda: dict(kernels.LAUNCHES))

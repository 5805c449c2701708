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
reference's XLA path does. With the recorder on (``repro_torch.obs``) a
dispatch leaves ``engine.run`` over one ``engine.superstep`` a superstep,
each over its local sweeps' launches (``engine.sweep``) and the reads
that decide a loop (``engine.read``, counted in ``engine.host_reads``),
then ``engine.gather`` (the master-slot gather and finalize).

Batched queries (the serving scenario) answer S queries in one superstep
loop. Where the reference vmaps its whole loop, the port vmaps only the
program's per-lane hooks (``torch.func.vmap``) and lays the S lanes out
as a trailing axis, ``[K, Vmax, S(, F)]``: each sweep is one
``segment_reduce`` (or, for the ``edge_mul`` programs, ``gspmm``) launch
and each superstep one ``exchange`` launch at F = S·F for the whole
micro-batch. A value every lane shares (a lane axis of stride 0, as vmap
hands back what no lane's input reached) is swept once for all lanes.
Per-lane masks on the device stop each lane where its solo run would
stop, so every lane's state and counters are its solo run's.

``Engine(plan, group=...)`` is the multi-device path, the reference's
``shard_map`` over a 1-d mesh: one rank of a ``torch.distributed`` process
group takes the place of one device. Each rank sweeps its block of ``K /
world`` partitions (``plan.shard_plan``) with the same kernels; the
exchange scatters the block's replicated slots into a global frontier,
all-reduces it across the ranks and gathers it back through the
glob-form ``masked_update`` kernel (``kernels.exchange_sharded``); the
superstep's change flags (per lane in a batch), the local-iteration
counts (max: the critical path) and the final master-slot gather are
all-reduced too. Collectives sit only there, so local fixed points run
rank-locally, like the paper's workers between synchronisations.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, NamedTuple

import torch
from torch.func import vmap

from .. import obs as _obs
from ..core import collectives as C
from . import kernels
from .errors import BatchAxisError, WarmStateError
from .plan import PartitionPlan, shard_plan
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
    CUDA events recorded before the dispatch's first launch and after the
    final gather and finalize. ``block_until_ready()`` waits for the end
    event; ``result()`` waits, then hands the ``EngineResult`` over. The
    superstep loop reads the device once a sweep, so by the time
    ``dispatch`` returns only the finalize may still be running: the
    handle overlaps next to nothing with the caller's work, and the time
    the dispatch held the device is :meth:`device_s`, not the wait."""
    _arrays: tuple                  # (state, supersteps, local_iters,
                                    #   converged)
    exchange_per_superstep: int
    _event: Any = None              # torch.cuda.Event, or None on the CPU
    _start: Any = None              # a torch.cuda.Event with timing, or
                                    #   the host clock (s) on the CPU
    _end_s: float = 0.0             # host clock at the end on the CPU

    def block_until_ready(self) -> "PendingResult":
        if self._event is not None:
            self._event.synchronize()
        return self

    def device_s(self) -> float:
        """Seconds from the dispatch's first launch to its ready result:
        the time between the start and end events on the card (waits for
        the end event), the host time of the whole loop on the CPU."""
        if self._event is None:
            return self._end_s - self._start
        self._event.synchronize()
        return self._start.elapsed_time(self._event) * 1e-3

    def result(self) -> EngineResult:
        state, supersteps, local_iters, converged = \
            self.block_until_ready()._arrays
        ex = self.exchange_per_superstep
        rec = _obs.get()
        if rec.enabled:   # per-dispatch superstep + exchange accounting
            # the event's three numbers in the one host copy the result
            # takes anyway (a torch reduction in the event's arguments
            # would launch device work and a read per served result)
            steps, li, conv = torch.stack([
                torch.as_tensor(supersteps).max().long(),
                torch.as_tensor(local_iters).max().long(),
                torch.as_tensor(converged).all().long()]).tolist()
            rec.event("engine.result", supersteps=steps, local_iters=li,
                      converged=bool(conv), exchange_per_superstep=ex,
                      exchanged=steps * ex)
            rec.counter("engine.supersteps", steps)
        else:
            steps = int(torch.as_tensor(supersteps).max())
        return EngineResult(state, supersteps, local_iters, converged, ex,
                            steps * ex)


def _start(plan) -> Any:
    """The start mark of a dispatch, taken before its first launch: a
    timing CUDA event recorded on the plan's card, or the host clock."""
    if plan.device.type != "cuda":
        return time.perf_counter()
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def _pending(plan, out: tuple, start) -> PendingResult:
    """Wrap a loop's output, with an end event recorded after its last op
    on the card (or the host clock read on the CPU)."""
    if not isinstance(start, torch.cuda.Event):
        return PendingResult(out, plan.exchange_volume, None, start,
                             time.perf_counter())
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return PendingResult(out, plan.exchange_volume, event, start)


def _read(rec, flag: torch.Tensor) -> bool:
    """``flag`` on the host: the one device→host read that decides a loop,
    recorded (span ``engine.read``, counter ``engine.host_reads``) while
    the recorder is on."""
    if not rec.enabled:
        return bool(flag)
    rec.counter("engine.host_reads")
    with rec.span("engine.read"):
        return bool(flag)


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


def _shared(x: torch.Tensor, axis: int) -> bool:
    """True where every index of ``x`` along ``axis`` is one tensor: an
    axis of stride 0, as ``torch.func.vmap`` hands back an output that no
    lane's input reached (an ``expand``), so all hold the same values."""
    return x.ndim > axis and x.shape[axis] > 1 and x.stride(axis) == 0


def _spread(x: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """``x`` with a new axis of ``n`` at ``axis``, shared (stride 0)."""
    x = x.unsqueeze(axis)
    shape = list(x.shape)
    shape[axis] = n
    return x.expand(shape)


def _planes(fn, plan: PartitionPlan, x: torch.Tensor, combine: str):
    """``fn(plan, x, combine)`` for a kernel wrapper, with ``x``
    [K, N, *tail] laid out as the kernels take it: [K, N] or [K, N, F]
    with F contiguous. A batched state's tail (lanes, features) is
    flattened into F, which the kernels treat column by column, and
    restored on the result; lanes that share one plane (axis 2 of stride
    0) run it once."""
    if _shared(x, 2):
        return _spread(_planes(fn, plan, x.select(2, 0), combine), 2,
                       x.shape[2])
    if x.ndim <= 3:
        return fn(plan, x.contiguous(), combine)
    k, tail = x.shape[0], tuple(x.shape[2:])
    out = fn(plan, x.reshape(k, x.shape[1], -1).contiguous(), combine)
    return out.view((k, out.shape[1]) + tail)


def _sweep(plan: PartitionPlan, prog: EdgeProgram, state, ctx, *,
           use_kernels: bool, lanes: bool = False):
    """One Gather-Apply sweep: per-target aggregate [K, Vmax(, ...)].
    ``lanes``: ``prog`` is a :func:`_lane_program`, its state's axis 2
    the lanes."""
    pre = prog.pre(state, ctx)                              # [K, Vmax(, F)]
    if prog.edge_mul is not None:   # gSpMM path (GNN programs)
        w = prog.edge_mul(plan, ctx)
        spmm = kernels.gspmm if use_kernels else kernels.gspmm_ref
        if lanes:
            return _lane_gspmm(spmm, plan, pre, w, prog.combine)
        agg = spmm(plan, pre, w, prog.combine)              # [K, Vmax, F]
        return agg[:, :, 0] if pre.ndim == 2 else agg
    rows = torch.arange(plan.k, device=pre.device)[:, None]
    msgs = pre[rows, plan.index64("edge_nbr")]              # [K, Emax(, F)]
    if prog.edge is not None:   # per-half-edge hook (weighted programs)
        msgs = prog.edge(msgs, plan, ctx)
    seg = kernels.segment_reduce if use_kernels \
        else kernels.segment_reduce_ref
    return _planes(seg, plan, msgs, prog.combine)


def _lane_gspmm(spmm, plan: PartitionPlan, pre: torch.Tensor,
                w: torch.Tensor, combine: str) -> torch.Tensor:
    """One ``spmm`` call for every lane. ``pre`` [K, Vmax, S(, F)] and the
    lanes' weights ``w`` [K, Emax, S] (scalar) or [K, Emax, S, F] (per
    feature) ride gspmm's feature axis as S·F columns, which it treats
    one by one (a mean divides each by the same live degree). Scalar
    weights the lanes share stay one [K, Emax] plane; where features and
    weights are both shared, one lane's F columns run. Returns
    [K, Vmax, S(, F)]."""
    feats = pre if pre.ndim == 4 else pre[..., None]        # [K,Vmax,S,F]
    w4 = w if w.ndim == 4 else w[..., None]                 # [K,Emax,S,·]
    k, v_max, n, f = feats.shape
    if _shared(feats, 2) and _shared(w4, 2):
        one = w4[:, :, 0]
        agg = _spread(spmm(plan, feats[:, :, 0].contiguous(),
                           one[..., 0] if one.shape[2] == 1 else
                           one.contiguous(), combine), 2, n)
    else:
        flat = feats.expand(k, v_max, n, f).reshape(k, v_max, n * f)
        if _shared(w4, 2) and w4.shape[3] == 1:
            weights = w4[:, :, 0, 0].contiguous()           # [K, Emax]
        else:
            weights = w4.expand(k, plan.e_max, n, f).reshape(
                k, plan.e_max, n * f).contiguous()
        agg = spmm(plan, flat.contiguous(), weights,
                   combine).view(k, v_max, n, f)
    return agg if pre.ndim == 4 else agg[..., 0]


def _exchange(plan: PartitionPlan, values, combine: str, *,
              use_kernels: bool, group=None):
    """Combine replicated slots across partitions; private slots unchanged.

    values [K, Vmax(, ...)] -> same shape. With ``use_kernels`` one launch
    over the plan's replica layout (``kernels.exchange``); else the
    reference's scatter-and-gather chain (``kernels.exchange_ref``). With
    a ``group``, ``plan`` is this rank's block and the combine runs across
    the ranks (``kernels.exchange_sharded``, closed by the
    ``masked_update`` kernel, or its plain version without
    ``use_kernels``).
    """
    if group is None:
        fn = kernels.exchange if use_kernels else kernels.exchange_ref
    else:
        update = kernels.masked_update if use_kernels \
            else kernels.masked_update_ref

        def fn(p, x, c):
            return kernels.exchange_sharded(p, x, c, group, update=update)
    return _planes(fn, plan, values, combine)


def _gather_global(plan: PartitionPlan, state, group=None):
    """Master-slot scatter of the final local states to a global [V(, F)]
    (summed across the ranks of ``group``: each vertex has one master)."""
    tail = tuple(state.shape[2:])
    idx = plan.index64("local2global").reshape(-1)
    out = torch.zeros((plan.n_vertices,) + tail, dtype=torch.float32,
                      device=state.device)
    out.index_add_(0, idx, torch.where(_expand(plan.is_master, state),
                                       state, 0.0).reshape((-1,) + tail))
    present = torch.zeros(plan.n_vertices, dtype=torch.int32,
                          device=state.device)
    present.index_add_(0, idx, plan.is_master.reshape(-1).to(torch.int32))
    if group is not None:
        C.all_reduce_(out, "sum", group)
        C.all_reduce_(present, "sum", group)
    return out, present > 0


def _across(flags: torch.Tensor, group) -> torch.Tensor:
    """Boolean ``flags`` OR-ed across the ranks of ``group`` (an int32
    max), or ``flags`` themselves without one."""
    if group is None:
        return flags
    return C.all_reduce_(flags.to(torch.int32).reshape(-1), "max",
                         group).view(flags.shape) > 0


def _run_loop(plan: PartitionPlan, prog: EdgeProgram, kw: dict,
              prev: torch.Tensor | None, max_supersteps: int,
              max_local_iters: int, use_kernels: bool, group=None):
    """The superstep loop. Returns (state, supersteps, local_iters,
    converged). With a ``group``, ``plan`` is this rank's block: the local
    phase runs on it alone, the exchange, the superstep's change test and
    the final gather run across the ranks, and ``local_iters`` is the
    largest rank's (the critical path)."""
    rec = _obs.get()
    ctx = prog.prepare(plan, kw)
    state0 = prog.init(plan, ctx) if prev is None \
        else prog.warm_init(plan, prev, ctx)

    if prog.mode == "replica":
        def local_phase(st):
            def sweep(s):
                with rec.span("engine.sweep"):
                    return prog.apply(s, _sweep(plan, prog, s, ctx,
                                                use_kernels=use_kernels),
                                      ctx)

            if not prog.local_fixpoint:   # exactly one sweep, uncapped
                return sweep(st), 1
            it, changed = 0, True
            while changed and it < max_local_iters:
                ns = sweep(st)
                it += 1
                changed = _read(rec, (ns != st).any())
                st = ns
            return st, it

        st, steps, litot, changed = state0, 0, 0, True
        while changed and steps < max_supersteps:
            with rec.span("engine.superstep"):
                st1, li = local_phase(st)
                st2 = _exchange(plan, st1, prog.combine,
                                use_kernels=use_kernels, group=group)
                changed = _read(rec, _across((st2 != st).any(), group))
            st, steps, litot = st2, steps + 1, litot + li
        converged = not changed   # still changing => the cap cut us off
    else:  # partial aggregation: lock-step, fixed superstep count
        st = state0
        for _ in range(max_supersteps):
            with rec.span("engine.superstep"):
                with rec.span("engine.sweep"):
                    agg = _sweep(plan, prog, st, ctx,
                                 use_kernels=use_kernels)
                full = _exchange(plan, agg, prog.combine,
                                 use_kernels=use_kernels, group=group)
                st = prog.apply(st, full, ctx)
        steps = litot = max_supersteps
        converged = True          # fixed-iteration programs by design

    if group is not None:   # local sweeps differ per rank: the critical path
        litot = int(C.all_reduce_(torch.tensor([litot], dtype=torch.int32,
                                               device=st.device), "max",
                                  group))
    with rec.span("engine.gather"):
        glob, present = _gather_global(plan, st, group)
        return (prog.finalize(glob, present, plan, ctx), steps, litot,
                converged)


def _lane_map(fn, args: tuple, axes: tuple, out_axis: int, n: int):
    """``fn`` over ``n`` lanes: ``args[i]``, a tensor or a dict of them,
    carries its lanes on ``axes[i]``. A tensor whose lanes are shared
    (:func:`_shared`) enters ``fn`` once (vmap's ``in_dims`` None), so
    what only such tensors reach stays shared. The output carries its
    lanes on ``out_axis``."""
    def split(x, axis):
        return (x.select(axis, 0), None) if _shared(x, axis) else (x, axis)

    inputs, dims, batched = [], [], False
    for a, axis in zip(args, axes):
        if isinstance(a, dict):
            parts = {name: split(v, axis) for name, v in a.items()}
            inputs.append({name: p[0] for name, p in parts.items()})
            dims.append({name: p[1] for name, p in parts.items()})
            batched |= any(p[1] is not None for p in parts.values())
        else:
            x, d = split(a, axis)
            inputs.append(x)
            dims.append(d)
            batched |= d is not None
    if not batched:
        return _spread(fn(*inputs), out_axis, n)
    return vmap(fn, in_dims=tuple(dims))(*inputs).movedim(0, out_axis)


def _lane_program(prog: EdgeProgram, plan: PartitionPlan, n: int
                  ) -> EdgeProgram:
    """``prog`` with its per-sweep hooks mapped over ``n`` lanes: state,
    aggregates, messages and ``edge_mul``'s weights are [K, N, S(, F)]
    (lane axis 2, where the kernels want it), ``ctx`` has a leading lane
    axis."""
    def lanes(fn, axes):
        return lambda *args: _lane_map(fn, args, axes, 2, n)

    edge = edge_mul = None
    if prog.edge is not None:
        lane_edge = lanes(lambda m, c: prog.edge(m, plan, c), (2, 0))
        edge = lambda msgs, _plan, ctx: lane_edge(msgs, ctx)  # noqa: E731
    if prog.edge_mul is not None:
        lane_w = lanes(lambda c: prog.edge_mul(plan, c), (0,))
        edge_mul = lambda _plan, ctx: lane_w(ctx)  # noqa: E731
    return prog._replace(pre=lanes(prog.pre, (2, 0)),
                         apply=lanes(prog.apply, (2, 2, 0)), edge=edge,
                         edge_mul=edge_mul)


def _run_lanes(plan: PartitionPlan, prog: EdgeProgram, kw: dict,
               batched_kw: dict, prev: torch.Tensor | None,
               max_supersteps: int, max_local_iters: int, use_kernels: bool,
               group=None):
    """The superstep loop for S lanes at once, each lane the query
    ``{**kw, **lane of batched_kw}``. Returns (state [S, V(, F)],
    supersteps [S], local_iters [S], converged [S]), each lane's equal to
    its solo :func:`_run_loop`.

    The lanes ride the state's axis 2 through one sweep and one exchange
    for all of them. A lane whose solo loop would have stopped keeps its
    state and counters: the masks ``active`` (superstep loop) and ``lact``
    (local phase) stay on the device, and each loop reads the device once
    a sweep and once a superstep, as the solo loop does. With a ``group``
    the lanes' change flags and local-iteration counts are reduced with
    max across the ranks, as :func:`_run_loop` reduces a solo run's.
    """
    rec = _obs.get()
    n = int(next(iter(batched_kw.values())).shape[0])
    ctx = vmap(lambda b: prog.prepare(plan, {**kw, **b}))(batched_kw)
    if prev is None:
        st = _lane_map(lambda c: prog.init(plan, c), (ctx,), (0,), 2, n)
    else:
        st = _lane_map(lambda pv, c: prog.warm_init(plan, pv, c),
                       (prev, ctx), (0, 0), 2, n)
    if not _shared(st, 2):
        st = st.contiguous()                            # [K, Vmax, S(, F)]
    lane = _lane_program(prog, plan, n)
    dev = st.device

    def sweep(s):
        return lane.apply(s, _sweep(plan, lane, s, ctx,
                                    use_kernels=use_kernels, lanes=True),
                          ctx)

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
                with rec.span("engine.sweep"):
                    return (where(active, sweep(st), st),
                            active.to(torch.int32))
            it, lact = zeros(), active
            go = max_local_iters > 0
            while go:
                with rec.span("engine.sweep"):
                    ns = sweep(st)
                    changed = differs(ns, st)
                    st = where(lact, ns, st)
                    it += lact
                    lact = lact & changed & (it < max_local_iters)
                go = _read(rec, lact.any())
            return st, it

        steps, litot = zeros(), zeros()
        active = torch.ones(n, dtype=torch.bool, device=dev)
        changed = active
        go = max_supersteps > 0
        while go:
            with rec.span("engine.superstep"):
                st1, li = local_phase(st, active)
                st2 = where(active, _exchange(plan, st1, prog.combine,
                                              use_kernels=use_kernels,
                                              group=group), st)
                changed = torch.where(active,
                                      _across(differs(st2, st), group),
                                      changed)
                steps += active
                litot += li
                active = active & changed & (steps < max_supersteps)
                st = st2
                go = _read(rec, active.any())
        converged = ~changed      # still changing => the cap cut it off
    else:  # partial aggregation: lock-step, fixed superstep count
        for _ in range(max_supersteps):
            with rec.span("engine.superstep"):
                with rec.span("engine.sweep"):
                    agg = _sweep(plan, lane, st, ctx,
                                 use_kernels=use_kernels, lanes=True)
                full = _exchange(plan, agg, prog.combine,
                                 use_kernels=use_kernels, group=group)
                st = lane.apply(st, full, ctx)
        steps = litot = torch.full((n,), max_supersteps, dtype=torch.int32,
                                   device=dev)
        converged = torch.ones(n, dtype=torch.bool, device=dev)

    if group is not None:   # the critical path, lane by lane
        C.all_reduce_(litot, "max", group)
    with rec.span("engine.gather"):
        glob, present = _gather_global(plan, st, group)     # [V, S(, F)]
        state = _lane_map(lambda g, c: prog.finalize(g, present, plan, c),
                          (glob, ctx), (1, 0), 0, n)
        return state.contiguous(), steps, litot, converged


@dataclasses.dataclass(frozen=True)
class Engine:
    """Partitioned execution engine bound to a plan, on the plan's device.

    ``use_kernels`` (default True) routes sweeps and exchanges through the
    Hopper kernels; False runs the plain PyTorch versions.

    ``group`` (a ``torch.distributed`` process group, e.g.
    ``torch.distributed.group.WORLD``) shards the partitions over its
    ranks, the reference's ``Engine(plan, mesh=...)``: every rank builds
    an Engine on the same whole plan and makes the same calls; each sweeps
    its own ``K / world`` partitions (``plan.shard_plan``, made at its first
    dispatch; ``K % world != 0`` raises), the exchange combines across the
    ranks (``kernels.exchange_sharded``), and every rank returns the whole
    result. ``None`` (the default) is the single-device path.
    """
    plan: PartitionPlan
    use_kernels: bool = True
    group: Any = None

    def with_plan(self, plan: PartitionPlan) -> "Engine":
        """Rebind to a (patched or recompiled) plan."""
        return dataclasses.replace(self, plan=plan)

    def _local_plan(self) -> PartitionPlan:
        """The plan this process sweeps: the whole plan, or with a group
        this rank's block of it, made once per Engine (as the reference
        keeps its placed plan)."""
        if self.group is None:
            return self.plan
        cached = self.__dict__.get("_plan_local")
        if cached is None:
            cached = shard_plan(self.plan, C.rank(self.group),
                                C.world(self.group))
            object.__setattr__(self, "_plan_local", cached)
        return cached

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
                  epoch=self.plan.epoch,
                  sharded=self.group is not None,
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
        start = _start(self.plan)
        steps = _steps(prog, max_supersteps)
        prev = self._check_warm(prog, warm_state)
        with self._obs_dispatch(prog, 0), _obs.get().span("engine.run"):
            out = _run_loop(self._local_plan(), prog, kw, prev, steps,
                            max_local_iters, self.use_kernels, self.group)
        return _pending(self.plan, out, start)

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
        their lane). Programs on the ``gspmm`` path (``edge_mul``) carry
        the lanes on its feature axis: one launch a sweep for the batch."""
        start = _start(self.plan)
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
        with self._obs_dispatch(prog, n_batch), _obs.get().span("engine.run"):
            out = _run_lanes(self._local_plan(), prog, kw, batched_kw, prev,
                             steps, max_local_iters, self.use_kernels,
                             self.group)
        return _pending(self.plan, out, start)

    def run_batched(self, prog: EdgeProgram, batched_kw: dict,
                    max_supersteps: int | None = None,
                    max_local_iters: int = 100_000, warm_state=None,
                    **kw: Any) -> EngineResult:
        return self.dispatch_batched(prog, batched_kw, max_supersteps,
                                     max_local_iters, warm_state=warm_state,
                                     **kw).result()


_obs.get().register_provider("launches", lambda: dict(kernels.LAUNCHES))

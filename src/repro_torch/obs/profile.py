"""Static per-sweep cost models from the plan's own counts (PyTorch port).

The attribution layer's *price list*: for each (program, plan, batch
bucket) the engine can dispatch, price **one sweep** — one local
gather-apply body plus the superstep's replica exchange — from the plan's
live counts and the dispatch's widths, once, and scale it at sample time
by the measured number of sweeps.  The reference lowers the executable to
HLO and runs its roofline analyzer with every loop clamped to one trip;
the port has no HLO, so it counts the sweep's operations itself:

  * the sweep kernel: ``segment_reduce`` at F = lanes × features, or
    ``gspmm`` for the ``edge_mul`` programs (``kernels.*_work``, the same
    counts ``chip_smoke.py`` bounds every kernel with);
  * the neighbour gather that feeds ``segment_reduce`` and the program's
    hooks (``pre``, ``edge``, ``apply``), each priced as the ``[K, Vmax,
    F]`` (or ``[K, Emax, F]``) tensors it reads and writes, with one
    operation per element written; the fixed-point tests (and a batch's
    lane masks) likewise;
  * one ``exchange`` a superstep (``PendingResult.exchange_per_superstep``
    slots cross the cut); on a sharded engine instead the frontier
    scatter and the ``masked_update`` block, with the all-reduced ``glob
    [V(, F)]`` as ``coll_bytes_per_sweep``.

The result is a frozen ``CostModel`` (flops, HBM bytes, collective bytes,
arithmetic intensity) memoized in a module-level LRU keyed by what
changes the count: program name, the plan's static fields (k,
n_vertices, v_max, e_max, epoch, e_slots) and its live counts
(``kernels.plan_counts``, read once per plan), sharded-or-not, the serve
bucket, and the shape/dtype signature of ctx and batched arguments.
``max_supersteps`` and warm-start state are not part of the key — they
change trip counts and initial values, never the per-sweep cost.

Pricing must never break serving: every failure (a broken plan, a hook
that raises on its probe) degrades to an *error model* with zero costs
and the exception recorded in ``CostModel.error``; ``cost_model`` never
raises.  Cache hits/misses/errors are a registered obs provider
(``snapshot()["cost_models"]``), and each fresh model records a
``profile.compile`` event when the recorder is enabled.

This module must not import ``repro_torch.engine`` at import time (the
engine imports ``repro_torch.obs``); it duck-types the engine through its
``plan`` and ``group`` attributes and imports the kernels' counts inside
the function.
"""
from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any

from ..launch import mesh as _mesh
from . import recorder as _rec

# Device peaks for achieved-vs-attainable utilization: the card's float32
# (non-tensor-core) FLOP/s and HBM bytes/s from ``launch/mesh.py``, the
# peaks chip_smoke.py bounds every kernel with.  A card run below its
# power limit, or another card, reaches less: set the two variables for it.
PEAK_FLOPS = float(os.environ.get("REPRO_PEAK_FLOPS", _mesh.FP32_FLOPS))
PEAK_HBM_BPS = float(os.environ.get("REPRO_PEAK_BW", _mesh.HBM_BW))

_CACHE_CAP = 256


@dataclass(frozen=True)
class CostModel:
    """Per-sweep static cost of one dispatchable shape.

    ``flops_per_sweep`` / ``hbm_bytes_per_sweep`` / ``coll_bytes_per_sweep``
    are the counts of one sweep (one gather-apply body and one exchange);
    multiply by the measured sweep count (``cost()``) to price a dispatch.
    An ``error`` model (all costs zero, ``error`` set) is what a failed
    count degrades to — samples priced by it carry device time but no
    flop/byte attribution.  ``unmodeled_ops`` and ``hlo_chars`` are the
    reference's schema and stay 0: the count prices every plane-sized
    operation of the sweep, and the port lowers nothing.
    """

    program: str
    plan_key: tuple
    bucket: int | None
    sharded: bool
    flops_per_sweep: float
    hbm_bytes_per_sweep: float
    coll_bytes_per_sweep: float
    unmodeled_ops: int = 0
    hlo_chars: int = 0
    compile_s: float = 0.0
    error: str | None = None

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops_per_sweep / max(self.hbm_bytes_per_sweep, 1.0)

    def cost(self, sweeps: int) -> tuple[float, float, float]:
        """(flops, hbm_bytes, coll_bytes) for a dispatch that ran
        ``sweeps`` superstep/local-iteration bodies."""
        s = max(int(sweeps), 1)
        return (self.flops_per_sweep * s, self.hbm_bytes_per_sweep * s,
                self.coll_bytes_per_sweep * s)

    def attainable_s(self, sweeps: int) -> float:
        """Roofline lower bound on device time for ``sweeps`` sweeps: the
        slower of the compute and memory ceilings (collective bytes ride
        the HBM term — a deliberate single-node simplification)."""
        fl, by, _ = self.cost(sweeps)
        return max(fl / PEAK_FLOPS, by / PEAK_HBM_BPS)


_LOCK = threading.Lock()
_MODELS: OrderedDict[tuple, CostModel] = OrderedDict()
_STATS = {"hits": 0, "misses": 0, "errors": 0}


def _shape_sig(kw: dict | None) -> tuple:
    if not kw:
        return ()
    out = []
    for k in sorted(kw):
        v = kw[k]
        shape = tuple(getattr(v, "shape", ()))
        dtype = str(getattr(v, "dtype", type(v).__name__))
        out.append((k, shape, dtype))
    return tuple(out)


def _plan_key(plan: Any) -> tuple:
    return (plan.k, plan.n_vertices, plan.v_max, plan.e_max, plan.epoch,
            plan.e_slots)


def _plan_digest(plan: Any) -> tuple | None:
    """The live counts the model reads (memoized on the plan), or None
    when they cannot be read — the model then degrades to an error."""
    from ..engine import kernels
    try:
        return tuple(kernels.plan_counts(plan))
    except Exception:  # noqa: BLE001 — the count below reports it
        return None


def _loop_width(plan: Any, prog: Any, kw: dict,
                batched_kw: dict | None) -> tuple[int, int, bool]:
    """(lanes, the kernels' F, per-feature gspmm weights) of a dispatch:
    one lane's ``prepare`` and ``init`` run once to read the loop state's
    width (a GCN layer sweeps its input features, not its output's)."""
    import torch
    lanes, probe = 1, dict(kw)
    if batched_kw:
        lanes = int(next(iter(batched_kw.values())).shape[0])
        probe.update({n: torch.as_tensor(v)[0]
                      for n, v in batched_kw.items()})
    ctx = prog.prepare(plan, probe)
    state = prog.init(plan, ctx)
    width = int(state.numel()) // (plan.k * plan.v_max)
    per_feature = False
    if prog.edge_mul is not None:
        per_feature = prog.edge_mul(plan, ctx).ndim == 3
    return lanes, lanes * width, per_feature


def _sweep_count(engine: Any, prog: Any, kw: dict,
                 batched_kw: dict | None) -> tuple[float, float, float]:
    """(flops, hbm_bytes, coll_bytes) of one sweep: every plane-sized
    operation of the loop body (the per-lane counters of a batch, a few
    bytes each, are left out)."""
    from ..engine import kernels
    plan = engine.plan if engine.group is None else engine._local_plan()
    lanes, f, per_feature = _loop_width(plan, prog, kw, batched_kw)
    kv, ke = plan.k * plan.v_max, plan.k * plan.e_max
    replica = prog.mode == "replica"
    steps: list[tuple[int, int]] = []

    def plane(reads: int, writes: int, slots: int = kv) -> None:
        # float32 [K, slots, F] tensors read and written, an operation
        # per element
        steps.append((f * slots, 4 * f * slots * (reads + writes)))

    plane(1, 1)                                     # pre
    if prog.edge_mul is not None:                   # gather · mul · reduce
        steps.append(kernels.gspmm_work(plan, f, per_feature))
    else:
        # msgs = pre[rows, edge_nbr]: the int64 index, the rows, the msgs
        steps.append((0, 8 * ke + 4 * f * kv + 4 * f * ke))
        if prog.edge is not None:
            plane(1, 1, ke)                         # edge
        steps.append(kernels.segment_reduce_work(plan, f))
    plane(2, 1)                                     # apply
    if replica and prog.local_fixpoint:
        plane(2, 0)                                 # local change test
    if replica and lanes > 1:
        plane(2, 1)                                 # lane mask, sweep
        plane(2, 1)                                 # lane mask, superstep
    coll = 0
    if engine.group is None:
        steps.append(kernels.exchange_work(plan, f))
    else:
        # the frontier (replicated live values and their indices read,
        # glob filled and written), then the update closes the exchange
        c = kernels.plan_counts(plan)
        steps.append((f * c.rep_slots,
                      (4 * f + 8) * c.rep_slots + 8 * f * plan.n_vertices))
        steps.append(kernels.masked_update_work(plan, f))
        coll = 4 * f * plan.n_vertices
    if replica:
        plane(2, 0)                                 # superstep change test
    return (float(sum(s[0] for s in steps)),
            float(sum(s[1] for s in steps)), float(coll))


def cost_model(engine: Any, prog: Any, *, bucket: int | None = None,
               batched_kw: dict | None = None,
               max_supersteps: int | None = None, **kw: Any) -> CostModel:
    """The memoized per-sweep ``CostModel`` for one dispatchable shape.

    ``engine`` is duck-typed (``plan``, ``group``); ``prog`` is an
    ``EdgeProgram``.  Never raises — failures return an error model (also
    cached, so a persistently broken count is paid for once).
    ``max_supersteps`` is accepted for the reference's signature and
    changes nothing: the model is per sweep.
    """
    del max_supersteps
    t0 = time.perf_counter()      # a miss's compile_s includes the counts
    name = getattr(prog, "name", str(prog))
    try:
        plan_key = _plan_key(engine.plan)
        sharded = engine.group is not None
        digest = _plan_digest(engine.plan)
    except Exception:  # noqa: BLE001 — an engine without a plan
        plan_key, sharded, digest = (), False, None
    key = (name, plan_key, sharded, bucket, _shape_sig(kw),
           _shape_sig(batched_kw), digest)
    with _LOCK:
        model = _MODELS.get(key)
        if model is not None:
            _MODELS.move_to_end(key)
            _STATS["hits"] += 1
            return model
        _STATS["misses"] += 1

    try:
        flops, nbytes, coll = _sweep_count(engine, prog, kw, batched_kw)
        model = CostModel(
            program=name, plan_key=plan_key, bucket=bucket, sharded=sharded,
            flops_per_sweep=flops, hbm_bytes_per_sweep=nbytes,
            coll_bytes_per_sweep=coll,
            compile_s=time.perf_counter() - t0)
    except Exception as e:  # noqa: BLE001 — profiling never breaks serving
        model = CostModel(
            program=name, plan_key=plan_key, bucket=bucket, sharded=sharded,
            flops_per_sweep=0.0, hbm_bytes_per_sweep=0.0,
            coll_bytes_per_sweep=0.0,
            compile_s=time.perf_counter() - t0,
            error=f"{type(e).__name__}: {e}")
        with _LOCK:
            _STATS["errors"] += 1

    with _LOCK:
        _MODELS[key] = model
        while len(_MODELS) > _CACHE_CAP:
            _MODELS.popitem(last=False)

    rec = _rec.get()
    if rec.enabled:
        rec.event("profile.compile", program=model.program,
                  bucket=bucket, flops_per_sweep=model.flops_per_sweep,
                  hbm_bytes_per_sweep=model.hbm_bytes_per_sweep,
                  unmodeled_ops=model.unmodeled_ops,
                  compile_s=round(model.compile_s, 4),
                  error=model.error)
    return model


def profile_stats() -> dict:
    with _LOCK:
        return {"size": len(_MODELS), **_STATS}


def reset_models() -> None:
    """Drop all memoized models and zero the stats (tests)."""
    with _LOCK:
        _MODELS.clear()
        for k in _STATS:
            _STATS[k] = 0


_rec.get().register_provider("cost_models", profile_stats)

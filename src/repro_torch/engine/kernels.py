"""Hopper kernels for the partition-local engine layout, with their plain
PyTorch versions.

``segment_reduce``
    Per-target aggregates of per-half-edge messages over the plan's
    target-sorted CSR stream (every local sweep). CUDA C++ in
    ``csrc/segment_reduce.cu``: a segmented reduce over the CSR runs
    (``plan.run_start`` to ``last_slot``), one thread per target and one
    block per long (hub) run, plus a scatter of the unsorted append region.
    Replaces ``repro/engine/kernels.py::segment_scan`` (``_seg_kernel``).

``gspmm``
    The GNN sweep (DGL's ``u_mul_e_{sum,max,mean}``): gather neighbour
    feature rows, multiply by per-half-edge weights (scalar or per
    feature), combine per target. CUDA C++ in ``csrc/gspmm.cu``: a lane
    group over F per target, hub runs cut into chunks of a block each whose
    partial rows combine into the target by atomics, plus the append
    region.
    ``mean`` is the add result over the live degree, which
    ``segment_reduce`` counts. Replaces
    ``repro/engine/kernels.py::_gspmm_scan`` (``_gspmm_kernel``), wrapped
    there by ``gspmm``.

``masked_update``
    The replica update that closes every exchange: replicated slots take
    the cut-combined global value, private slots keep their own, padding is
    pinned to the identity. CUDA C++ in ``csrc/masked_update.cu``, fused
    with the ``glob[local2global]`` gather that feeds it. Replaces
    ``repro/engine/kernels.py::masked_update`` (``_update_kernel``).

Dispatch: a wrapper launches its kernel for CUDA tensors and runs its plain
version (``*_ref``) for CPU tensors; there is no fallback from one to the
other. Each launch adds one to :data:`LAUNCHES`, so a run can show that it
went through the kernels. All take scalar ``[K, ·]`` or feature-plane
``[K, ·, F]`` float32 values, F contiguous.

``gather_vertex_channel`` / ``gather_edge_channel`` lay external property
planes out to the partition-local shapes the programs consume; they are
plain indexing, not kernels.
"""
from __future__ import annotations

import math

import torch

from .. import cuda_build
from ..cuda_build import check as _check
from ..cuda_build import on_card as _on_card
from ..cuda_build import stream as _stream

_IDENTITY = {"min": math.inf, "add": 0.0, "max": -math.inf}
_OP_CODE = {"min": 0, "add": 1, "max": 2}
_SCATTER = {"min": "amin", "add": "sum", "max": "amax"}

#: Kernel launches per wrapper since the last :func:`reset_launches`.
LAUNCHES = {"segment_reduce": 0, "masked_update": 0, "gspmm": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_plan(plan, *names: str) -> None:
    """Check the plan fields a kernel reads (dtype, shape, contiguity)."""
    k, e_max, v_max = plan.k, plan.e_max, plan.v_max
    spec = {"emask": (torch.bool, (k, e_max)),
            "run_start": (torch.int32, (k, e_max)),
            "edge_tgt": (torch.int32, (k, e_max)),
            "edge_nbr": (torch.int32, (k, e_max)),
            "last_slot": (torch.int32, (k, v_max)),
            "vmask": (torch.bool, (k, v_max)),
            "csr_fill": (torch.int32, (k,))}
    for name in names:
        _check(getattr(plan, name), f"plan.{name}", *spec[name])


# ---------------------------------------------------------------------------
# segment_reduce
# ---------------------------------------------------------------------------

def segment_reduce(plan, messages: torch.Tensor,
                   combine: str = "min") -> torch.Tensor:
    """Per-target aggregates over the plan's CSR stream.

    messages [K, Emax] or [K, Emax, F] float32 -> aggregates [K, Vmax] /
    [K, Vmax, F] (identity at padding vertices). Masked slots, and CSR
    slots at or past ``csr_fill``, are the combine identity; live slots of
    the append region ``[csr_fill, e_max)`` are combined into their target
    on top. CUDA tensors launch the kernel; CPU tensors run
    :func:`segment_reduce_ref`.
    """
    if not _on_card(messages, plan.emask):
        return segment_reduce_ref(plan, messages, combine)
    squeeze = messages.ndim == 2
    k, e_max, v_max = plan.k, plan.e_max, plan.v_max
    f = 1 if squeeze else int(messages.shape[2])
    _check(messages, "messages", torch.float32,
           (k, e_max) if squeeze else (k, e_max, f))
    _check_plan(plan, "emask", "run_start", "edge_tgt", "last_slot", "vmask",
                "csr_fill")
    out = torch.empty((k, v_max, f), dtype=torch.float32,
                      device=messages.device)
    # scratch: a count, then the targets whose CSR run is long (hubs)
    work = torch.empty(1 + k * v_max, dtype=torch.int32,
                       device=messages.device)
    fn = cuda_build.entry("segment_reduce")
    ptrs = [t.data_ptr() for t in (messages, plan.emask, plan.run_start,
                                   plan.last_slot, plan.vmask, plan.edge_tgt,
                                   plan.csr_fill, out, work)]
    rc = fn(*ptrs, k, e_max, v_max, f,
            plan.csr_fill_min, _OP_CODE[combine], _stream())
    if rc != 0:
        raise RuntimeError(f"segment_reduce kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES["segment_reduce"] += 1
    return out[:, :, 0] if squeeze else out


def segment_reduce_ref(plan, messages: torch.Tensor,
                       combine: str = "min") -> torch.Tensor:
    """Plain version: one scatter of every live message into its target
    (the reference's ``segment_reduce_ref``), on a flattened
    ``k·Vmax + edge_tgt`` index."""
    ident = _IDENTITY[combine]
    squeeze = messages.ndim == 2
    msgs3 = messages[:, :, None] if squeeze else messages
    k, _, f = msgs3.shape
    msgs = torch.where(plan.emask[:, :, None], msgs3, ident)
    rows = torch.arange(k, device=msgs.device)[:, None] * plan.v_max
    idx = (rows + plan.index64("edge_tgt")).reshape(-1, 1).expand(-1, f)
    out = torch.full((k * plan.v_max, f), ident, dtype=torch.float32,
                     device=msgs.device)
    out.scatter_reduce_(0, idx, msgs.reshape(-1, f), _SCATTER[combine])
    out = torch.where(plan.vmask[:, :, None], out.view(k, plan.v_max, f),
                      ident)
    return out[:, :, 0] if squeeze else out


# ---------------------------------------------------------------------------
# gspmm
# ---------------------------------------------------------------------------

def _mean(plan, total: torch.Tensor, count_fn) -> torch.Tensor:
    """``mean``: the add aggregate ``total`` over the live degree clamped
    at 1 (isolated vertices aggregate to 0); ``count_fn`` counts the degree
    (``segment_reduce``, or its plain version on the plain path)."""
    ones = torch.ones(plan.emask.shape, dtype=torch.float32,
                      device=total.device)
    return total / count_fn(plan, ones, "add").clamp(min=1.0)[:, :, None]


def gspmm(plan, feats: torch.Tensor, weights: torch.Tensor,
          combine: str = "add") -> torch.Tensor:
    """Gather · multiply · segment-reduce in one kernel.

    feats   [K, Vmax, F] (or [K, Vmax]) local feature rows, float32;
    weights [K, Emax] scalar per half-edge (``plan.edge_w``) or
            [K, Emax, F] per feature (a gathered edge channel);
    combine "add"/"sum", "max", or "mean" (sum over the clamped live
            degree)
    -> [K, Vmax, F] per-target aggregates (always rank 3), identity at
    padding vertices. CUDA tensors launch the kernel; CPU tensors run
    :func:`gspmm_ref`.
    """
    if combine == "sum":
        combine = "add"
    if combine == "mean":
        return _mean(plan, gspmm(plan, feats, weights, "add"),
                     segment_reduce)
    if not _on_card(feats, weights, plan.emask):
        return gspmm_ref(plan, feats, weights, combine)
    feats3 = feats[:, :, None] if feats.ndim == 2 else feats
    k, e_max, v_max = plan.k, plan.e_max, plan.v_max
    f = int(feats3.shape[2])
    _check(feats3, "feats", torch.float32, (k, v_max, f))
    per_feature = weights.ndim == 3
    _check(weights, "weights", torch.float32,
           (k, e_max, f) if per_feature else (k, e_max))
    _check_plan(plan, "edge_nbr", "emask", "run_start", "last_slot", "vmask",
                "edge_tgt", "csr_fill")
    dev = feats3.device
    out = torch.empty((k, v_max, f), dtype=torch.float32, device=dev)
    # scratch: a count, then {target, first slot, last slot} per chunk of
    # the long (hub) runs; a long run is over 32 slots and gives at most one
    # chunk per 33 of them, so K·Emax/32 entries always suffice
    work = torch.empty(1 + 3 * (k * e_max // 32), dtype=torch.int32,
                       device=dev)
    fn = cuda_build.entry("gspmm")
    ptrs = [t.data_ptr() for t in (feats3, weights, plan.edge_nbr, plan.emask,
                                   plan.run_start, plan.last_slot, plan.vmask,
                                   plan.edge_tgt, plan.csr_fill, out, work)]
    rc = fn(*ptrs, k, e_max, v_max, f, int(per_feature), plan.csr_fill_min,
            _OP_CODE[combine], _stream())
    if rc != 0:
        raise RuntimeError(f"gspmm kernel launch failed: CUDA error {rc}")
    LAUNCHES["gspmm"] += 1
    return out


def gspmm_ref(plan, feats: torch.Tensor, weights: torch.Tensor,
              combine: str = "add") -> torch.Tensor:
    """Plain version: gather the neighbour rows, materialise the weighted
    message stream, and :func:`segment_reduce_ref` it (the reference's
    ``gspmm_ref``)."""
    if combine == "sum":
        combine = "add"
    if combine == "mean":
        return _mean(plan, gspmm_ref(plan, feats, weights, "add"),
                     segment_reduce_ref)
    feats3 = feats[:, :, None] if feats.ndim == 2 else feats
    rows = torch.arange(plan.k, device=feats3.device)[:, None]
    msgs = feats3[rows, plan.index64("edge_nbr")]           # [K, Emax, F]
    w3 = weights[:, :, None] if weights.ndim == 2 else weights
    return segment_reduce_ref(plan, msgs * w3, combine)


# ---------------------------------------------------------------------------
# property channels (plain indexing)
# ---------------------------------------------------------------------------

def gather_vertex_channel(plan, values: torch.Tensor) -> torch.Tensor:
    """values [V, F] (or [V]) -> [K, Vmax, F]: each live local slot takes
    its vertex's row through ``plan.local2global``; padding and reserved
    slack slots (``vmask`` False) are 0.0. Indices are masked and clamped
    first, so a pad slot never makes torch raise where the reference reads
    a clamped row."""
    if values.ndim == 1:
        values = values[:, None]
    n = int(values.shape[0])
    idx = torch.where(plan.vmask, plan.index64("local2global"), 0)
    local = values[idx.clamp(0, max(n - 1, 0))]             # [K, Vmax, F]
    return torch.where(plan.vmask[:, :, None], local, 0.0)


def gather_edge_channel(plan, values: torch.Tensor,
                        fill: float = 0.0) -> torch.Tensor:
    """values [E_pad, F] (or [E_pad]) in graph slot order -> [K, Emax, F]:
    every live half-edge takes its undirected edge's row through
    ``plan.edge_slot``; pad slots, slots of unknown provenance
    (``edge_slot == -1``) and slots past the supplied rows read ``fill``.
    The row index is clamped, so a plane shorter than ``e_pad`` fails soft
    and never aliases its last row."""
    if values.ndim == 1:
        values = values[:, None]
    n = int(values.shape[0])
    slot = plan.index64("edge_slot")
    ok = plan.emask & (slot >= 0) & (slot < n)
    local = values[slot.clamp(0, max(n - 1, 0))]            # [K, Emax, F]
    return torch.where(ok[:, :, None], local, fill)


# ---------------------------------------------------------------------------
# masked_update
# ---------------------------------------------------------------------------

def masked_update(state: torch.Tensor, glob: torch.Tensor,
                  local2global: torch.Tensor, vmask: torch.Tensor,
                  replicated: torch.Tensor,
                  combine: str = "min") -> torch.Tensor:
    """Replica update fused with its gather.

    state [K, Vmax(, F)], glob [V(, F)] float32, local2global [K, Vmax]
    int32, vmask/replicated [K, Vmax] bool ->
    ``where(!vmask, identity, where(replicated, glob[local2global], state))``.
    CUDA tensors launch the kernel; CPU tensors run
    :func:`masked_update_ref`.
    """
    if not _on_card(state, glob, local2global, vmask, replicated):
        return masked_update_ref(state, glob, local2global, vmask,
                                 replicated, combine)
    k, v_max = int(local2global.shape[0]), int(local2global.shape[1])
    tail = tuple(state.shape[2:])
    f = math.prod(tail)
    _check(state, "state", torch.float32, (k, v_max) + tail)
    _check(glob, "glob", torch.float32, (int(glob.shape[0]),) + tail)
    _check(local2global, "local2global", torch.int32, (k, v_max))
    _check(vmask, "vmask", torch.bool, (k, v_max))
    _check(replicated, "replicated", torch.bool, (k, v_max))
    out = torch.empty_like(state)
    fn = cuda_build.entry("masked_update")
    ptrs = [t.data_ptr() for t in (state, glob, local2global, vmask,
                                   replicated, out)]
    rc = fn(*ptrs, k * v_max, f, int(glob.shape[0]), _IDENTITY[combine],
            _stream())
    if rc != 0:
        raise RuntimeError(f"masked_update kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES["masked_update"] += 1
    return out


def masked_update_ref(state: torch.Tensor, glob: torch.Tensor,
                      local2global: torch.Tensor, vmask: torch.Tensor,
                      replicated: torch.Tensor,
                      combine: str = "min") -> torch.Tensor:
    """Plain version: gather ``glob[local2global]``, then the reference's
    two ``where``s (``runtime.py`` exchange tail)."""
    ident = _IDENTITY[combine]
    inc = glob[local2global.long()]                         # [K, Vmax(, F)]
    if state.ndim == 3:
        vmask, replicated = vmask[:, :, None], replicated[:, :, None]
    new = torch.where(replicated, inc, state)
    return torch.where(vmask, new, ident)

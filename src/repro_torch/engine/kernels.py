"""Hopper kernels for the partition-local engine layout, with their plain
PyTorch versions.

``segment_reduce``
    Per-target aggregates of per-half-edge messages over the plan's
    target-sorted CSR stream (every local sweep). CUDA C++ in
    ``csrc/segment_reduce.cu``: a segmented reduce that walks the CSR, one
    thread per target and one block per long (hub) run, plus a scatter of
    the unsorted append region.
    Replaces ``repro/engine/kernels.py::segment_scan`` (``_seg_kernel``).

``masked_update``
    The replica update that closes every exchange: replicated slots take
    the cut-combined global value, private slots keep their own, padding is
    pinned to the identity. CUDA C++ in ``csrc/masked_update.cu``, fused
    with the ``glob[local2global]`` gather that feeds it. Replaces
    ``repro/engine/kernels.py::masked_update`` (``_update_kernel``).

Dispatch: a wrapper launches its kernel for CUDA tensors and runs its plain
version (``*_ref``) for CPU tensors; there is no fallback from one to the
other. Each launch adds one to :data:`LAUNCHES`, so a run can show that it
went through the kernels. Both take scalar ``[K, ·]`` or feature-plane
``[K, ·, F]`` float32 values, F contiguous.
"""
from __future__ import annotations

import math

import torch

from .. import cuda_build

_IDENTITY = {"min": math.inf, "add": 0.0, "max": -math.inf}
_OP_CODE = {"min": 0, "add": 1, "max": 2}
_SCATTER = {"min": "amin", "add": "sum", "max": "amax"}

#: Kernel launches per wrapper since the last :func:`reset_launches`.
LAUNCHES = {"segment_reduce": 0, "masked_update": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_card(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; anything else (or a
    mix) raises — the caller never silently changes device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"tensors must all be on one CPU or CUDA device, got "
                     f"{sorted({str(t.device) for t in tensors})}")


def _check(t: torch.Tensor, name: str, dtype: torch.dtype,
           shape: tuple) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor of shape "
            f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)} "
            f"(contiguous={t.is_contiguous()})")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


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
    for name, dtype, shape in (("emask", torch.bool, (k, e_max)),
                               ("seg_start", torch.bool, (k, e_max)),
                               ("edge_tgt", torch.int32, (k, e_max)),
                               ("last_slot", torch.int32, (k, v_max)),
                               ("vmask", torch.bool, (k, v_max)),
                               ("csr_fill", torch.int32, (k,))):
        _check(getattr(plan, name), f"plan.{name}", dtype, shape)
    out = torch.empty((k, v_max, f), dtype=torch.float32,
                      device=messages.device)
    # scratch: a count, then the targets whose CSR run is long (hubs)
    work = torch.empty(1 + k * v_max, dtype=torch.int32,
                       device=messages.device)
    fn = cuda_build.entry("segment_reduce")
    ptrs = [t.data_ptr() for t in (messages, plan.emask, plan.seg_start,
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

"""Collectives over ``torch.distributed`` process groups: the mesh axes of
the reference's ``shard_map`` and GSPMD programs.

One device of the reference's mesh is one rank: ``lax.axis_index`` is
:func:`rank`, an axis size is :func:`world`, every ``lax.psum`` /
``pmin`` / ``pmax`` is :func:`all_reduce_` with ``"sum"`` / ``"min"`` /
``"max"``, and an all-gather or a reduce-scatter that GSPMD inserts for a
split leaf is :func:`all_gather` / :func:`reduce_scatter`. The autograd
functions below are the sharded LM's conjugate pairs: :func:`gather_shard`
(all-gather forward, reduce-scatter backward: an fsdp leaf),
:func:`copy_to_tp` (identity forward, all-reduce backward: the entry of a
tensor-parallel region) and :func:`reduce_from_tp` (all-reduce forward,
identity backward: its exit), as Megatron-LM pairs them. Each autograd
function keeps the group it ran on, since a backward may run on another
thread than its forward.

One code path runs over NCCL (a rank a card) and gloo (several ranks on
one card, or the CPU): gloo takes ``all_reduce``,
``all_gather_into_tensor`` and ``reduce_scatter_tensor`` on CPU and CUDA
tensors of int32, int64, float32 and bfloat16 (torch 2.11 on the H100's
machine, 2.13 on the CPU). ``group=None`` is the default (world) group.
Every function raises if no process group is initialised: nothing quietly
runs as one rank, and a collective's failure propagates.

A collective over a group of one rank moves nothing and is not called
(an all-reduce leaves its tensor, an all-gather or a reduce-scatter
returns a copy): gloo would round-trip CUDA tensors through the host for
it. :data:`BYTES` counts what each kind moves on the other groups, in the
dry run's convention (``roofline/analysis.py``): an all-gather its
gathered tensor, a reduce-scatter the tensor it scatters, an all-reduce
twice its tensor (a ring's reduce-scatter and all-gather).
:func:`record_events` adds CUDA events around each call, by kind.
"""
from __future__ import annotations

import contextlib
import warnings

import torch
import torch.distributed as dist

#: The reduce of each combine.
OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
       "max": dist.ReduceOp.MAX}
_DTYPES = (torch.int32, torch.int64, torch.float32, torch.bfloat16)
KINDS = ("all-gather", "reduce-scatter", "all-reduce")
#: Bytes moved by kind since the last :func:`reset_bytes`.
BYTES = dict.fromkeys(KINDS, 0)
_EVENTS: list | None = None


def _require() -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no torch.distributed process group is initialised: call "
            "torch.distributed.init_process_group (torchrun, or "
            "init_method/world_size/rank) before a sharded entry point")


def _check(t: torch.Tensor, what: str) -> None:
    if t.dtype not in _DTYPES or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous int32, int64, "
                         f"float32 or bfloat16 tensor, got {t.dtype} "
                         f"(contiguous={t.is_contiguous()})")


def reset_bytes() -> None:
    for k in KINDS:
        BYTES[k] = 0


@contextlib.contextmanager
def record_events(sink: list):
    """Inside the block, append ``(kind, start, end)`` CUDA events around
    every collective of this module (no host sync is added)."""
    global _EVENTS
    prev, _EVENTS = _EVENTS, sink
    try:
        yield sink
    finally:
        _EVENTS = prev


def _run(kind: str, nbytes: int, group, fn) -> None:
    BYTES[kind] += nbytes
    if _EVENTS is None:
        fn()
        return
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    _EVENTS.append((kind, start, end))


def rank(group=None) -> int:
    """This process's rank in ``group`` (the reference's axis index)."""
    _require()
    return dist.get_rank(group)


def world(group=None) -> int:
    """The number of ranks in ``group`` (the reference's mesh axis size)."""
    _require()
    return dist.get_world_size(group)


def all_reduce_(t: torch.Tensor, op: str, group=None) -> torch.Tensor:
    """Reduce ``t`` in place across ``group`` with ``op`` ("sum", "min" or
    "max") and return it."""
    _require()
    _check(t, "all_reduce_")
    if dist.get_world_size(group) > 1:
        _run("all-reduce", 2 * t.numel() * t.element_size(), group,
             lambda: dist.all_reduce(t, op=OPS[op], group=group))
    return t


def all_gather(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order (a new
    tensor)."""
    _require()
    n = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    _check(src, "all_gather")
    if n == 1:
        return t.clone()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    _run("all-gather", out.numel() * out.element_size(), group,
         lambda: _quiet(dist.all_gather_into_tensor, out, src, group))
    return out.movedim(0, dim)


def reduce_scatter(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The sum of every rank's ``t`` over ``group``, this rank's block of
    it along ``dim`` (``t.shape[dim]`` must divide by the group's size)."""
    _require()
    n = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    _check(src, "reduce_scatter")
    if src.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim of {src.shape[0]} over "
                         f"{n} ranks")
    if n == 1:
        return t.clone()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    _run("reduce-scatter", src.numel() * src.element_size(), group,
         lambda: _quiet(dist.reduce_scatter_tensor, out, src, group))
    return out.movedim(0, dim)


def _quiet(fn, out, src, group) -> None:
    """``fn`` without its FutureWarning: newer torch renames
    ``all_gather_into_tensor`` and ``reduce_scatter_tensor``, and the
    card's torch 2.11 has only these names."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        fn(out, src, group=group)


class _GatherShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, full, group):
        ctx.dim, ctx.group, ctx.shard = dim, group, t.shape[dim]
        return all_gather(t, dim, group).narrow(dim, 0, full).contiguous()

    @staticmethod
    def backward(ctx, g):
        n = world(ctx.group)
        pad = n * ctx.shard - g.shape[ctx.dim]
        if pad:
            shape = list(g.shape)
            shape[ctx.dim] = pad
            g = torch.cat([g, g.new_zeros(shape)], dim=ctx.dim)
        return reduce_scatter(g, ctx.dim, ctx.group), None, None, None


def gather_shard(t: torch.Tensor, dim: int, full: int, group
                 ) -> torch.Tensor:
    """An fsdp leaf's shard ``t`` all-gathered along ``dim`` and cut to its
    ``full`` length; the gradient is reduce-scattered back to the shards
    (summed over ``group``, zero-padded as ``shard_tensor`` pads)."""
    return _GatherShard.apply(t, dim, full, group)


class _CopyToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), "sum", ctx.group), None


class _ReduceFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce (sum) of the gradient backward: where
    a tensor replicated over ``group`` enters work each rank does a part
    of, so its gradient sums every rank's part."""
    return _CopyToTp.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) forward, identity backward: the partial results of
    a tensor-parallel region summed into a tensor replicated over
    ``group``."""
    return _ReduceFromTp.apply(x, group)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def scale_grad(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Identity forward, the gradient times ``scale`` backward: a term
    every rank of a region computes whole, whose gradient the region's
    exit then sums over its ``1 / scale`` ranks."""
    return _ScaleGrad.apply(x, scale)

"""The mesh axis of the reference's ``shard_map``, as a ``torch.distributed``
process group.

One device of the reference's 1-d mesh is one rank of a process group:
``lax.axis_index`` is :func:`rank`, the axis size is :func:`world`, and
every ``lax.psum``/``pmin``/``pmax`` over the axis is :func:`all_reduce_`
with ``"sum"``/``"min"``/``"max"``. Only ``all_reduce`` is used, on int32
and float32 tensors (flags travel as int32, as the reference casts them):
gloo takes ``all_reduce`` on CUDA tensors as NCCL does, so one code path
runs over both, NCCL for a rank a card and gloo for several ranks on one
card or on the CPU.

``group=None`` is the default (world) group. Every function here raises if
no process group is initialised: nothing quietly runs as one rank.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

#: The reduce of each combine.
OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
       "max": dist.ReduceOp.MAX}
_DTYPES = (torch.int32, torch.float32)


def _require() -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no torch.distributed process group is initialised: call "
            "torch.distributed.init_process_group (torchrun, or "
            "init_method/world_size/rank) before a sharded entry point")


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
    "max") and return it. ``t`` is a contiguous int32 or float32 tensor."""
    _require()
    if t.dtype not in _DTYPES or not t.is_contiguous():
        raise ValueError(f"all_reduce_: expected a contiguous int32 or "
                         f"float32 tensor, got {t.dtype} "
                         f"(contiguous={t.is_contiguous()})")
    dist.all_reduce(t, op=OPS[op], group=group)
    return t

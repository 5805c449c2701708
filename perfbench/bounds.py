"""The benchmark's frozen yardstick for kernel rooflines.

Peaks of one NVIDIA H100 SXM5 80GB from its data sheet (dense rates, at the
card's 700 W power limit), and the (operations, bytes) of one launch of each
kernel the cells time, counted from the call's shapes: each input byte read
once, each output byte written once.

Copied from the port's own counts so that the program cannot move them:

* ``HBM_BYTES_PER_S``, ``FP32_FLOPS``: ``src/repro_torch/launch/mesh.py``
  (``HBM_BW``, ``FP32_FLOPS``), which ``chip_smoke.py``'s ``_bound`` divides
  by;
* :func:`plan_counts`, :func:`segment_reduce_work`, :func:`exchange_work`:
  ``src/repro_torch/engine/kernels.py`` (``plan_counts``,
  ``segment_reduce_work``, ``exchange_work``), the counts behind
  ``chip_smoke.py``'s ``_seg_bound`` and ``_exchange_bound``;
* :func:`lane_cumsum_work`: ``chip_smoke.py``'s ``_lane_cumsum_section``
  (``_bound(8 * s * k, s * k)``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

#: HBM3 bytes/s of one H100 SXM5.
HBM_BYTES_PER_S = 3.35e12
#: float32 FLOP/s on the CUDA cores of one H100 SXM5.
FP32_FLOPS = 67e12


class PlanCounts(NamedTuple):
    """Live counts of a partition plan, read from its masks."""
    k: int
    v_max: int
    e_max: int
    live: int          # live half-edge slots
    append_live: int   # live slots in the append region [csr_fill, e_max)
    live_slots: int    # live local-vertex slots
    rep_slots: int     # live replicated local-vertex slots
    rep_groups: int    # distinct vertices with replicated slots


def plan_counts(plan) -> PlanCounts:
    """The counts of a ``PartitionPlan`` (any object with its fields)."""
    slot = torch.arange(plan.e_max, device=plan.emask.device)[None, :]
    rep = plan.vmask & plan.replicated
    return PlanCounts(
        k=int(plan.k), v_max=int(plan.v_max), e_max=int(plan.e_max),
        live=int(plan.emask.sum()),
        append_live=int((plan.emask
                         & (slot >= plan.csr_fill[:, None])).sum()),
        live_slots=int(plan.vmask.sum()),
        rep_slots=int(rep.sum()),
        rep_groups=int(torch.unique(plan.local2global[rep]).numel()))


def segment_reduce_work(c: PlanCounts, f: int) -> tuple[int, int]:
    """(operations, bytes) of one segmented reduce at width ``f``: each live
    message read once and combined once, the masks and per-target indices
    read once, each aggregate written once."""
    kv, ke = c.k * c.v_max, c.k * c.e_max
    nbytes = (4 * f * c.live + 2 * ke + 5 * kv + 4 * c.k
              + 4 * c.append_live + 4 * f * kv)
    return f * c.live, nbytes


def exchange_work(c: PlanCounts, f: int) -> tuple[int, int]:
    """(operations, bytes) of one replica exchange at width ``f``: each live
    slot's value read once, each group's slot indices and pointer read
    once, both masks read once, every slot written once."""
    kv = c.k * c.v_max
    nbytes = (4 * f * c.live_slots + 4 * (c.rep_slots + c.rep_groups + 1)
              + 2 * kv + 4 * f * kv)
    return 0, nbytes


def lane_cumsum_work(rows: int, lanes: int) -> tuple[int, int]:
    """(operations, bytes) of one inclusive int32 cumsum down ``rows`` of
    an [rows, lanes] array: one add per element, each read and written
    once."""
    return rows * lanes, 8 * rows * lanes


def least_seconds(work: tuple[int, int]) -> float:
    """The least time the card could take for ``(operations, bytes)``: the
    larger of bytes over HBM bandwidth and operations over float32 peak."""
    ops, nbytes = work
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS)

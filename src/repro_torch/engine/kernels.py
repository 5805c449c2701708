"""Hopper kernels for the partition-local engine layout, with their plain
PyTorch versions.

``segment_reduce``
    Per-target aggregates of per-half-edge messages over the plan's
    target-sorted CSR stream (every local sweep). CUDA C++ in
    ``csrc/segment_reduce.cu``: one launch over a :class:`SegmentLayout`
    built once per plan (:func:`segment_layout`): tiles of consecutive
    targets stage their slot window in shared memory and reduce each short
    run there (a thread, or a warp for a longer run); longer runs are units
    of their own (a block each); each target's
    live append-region slots are pulled by its owner. Every target has one
    writer, so there are no atomics and the order of a sum is fixed.
    Replaces ``repro/engine/kernels.py::segment_scan`` (``_seg_kernel``).

``gspmm``
    The GNN sweep (DGL's ``u_mul_e_{sum,max,mean}``): gather neighbour
    feature rows, multiply by per-half-edge weights (scalar or per
    feature), combine per target. CUDA C++ in ``csrc/gspmm.cu``: one
    launch over the same :class:`SegmentLayout` and a :class:`GspmmLayout`
    of it (:func:`gspmm_layout`, built once per plan): a tile block stages
    its window's row indices, weights and slot targets and splits the
    window's slots evenly over lane groups that gather several rows at
    once, runs crossing a group's end finished with the next groups'
    partials; longer runs are cut into chunks of a block each, whose
    partial rows the last chunk to arrive combines in order; each target's
    append slots are pulled by its writer. No atomic touches a value, so
    the order of a sum is fixed. ``mean`` is the add result over the live
    degree, which ``segment_reduce`` counts. Replaces
    ``repro/engine/kernels.py::_gspmm_scan`` (``_gspmm_kernel``), wrapped
    there by ``gspmm``.

``exchange``
    The replica exchange of every superstep: each replicated vertex's live
    slots are combined across partitions and the result written back to
    each, private slots keep their own, padding is pinned to the identity.
    CUDA C++ in ``csrc/replica_exchange.cu``: one launch over an
    :class:`ExchangeLayout` built once per plan (:func:`exchange_layout`),
    which lists each replicated vertex's live slots in ascending partition;
    a thread (two at F = 8) folds a group in that order and writes it back,
    so no global frontier, no atomics, and the order of a sum is fixed.
    Replaces ``repro/engine/kernels.py::masked_update``
    (``_update_kernel``) with the scatter that feeds it in the reference's
    ``runtime._exchange``.

``masked_update``
    The glob-form replica update: replicated slots take a global frontier
    ``glob [V(, F)]`` combined elsewhere, private slots keep their own,
    padding is pinned to the identity. CUDA C++ in
    ``csrc/masked_update.cu``, fused with the ``glob[local2global]`` gather
    that feeds it. It closes every exchange of the multi-device path
    (:func:`exchange_sharded`), whose ``glob`` is all-reduced across the
    ranks before the update; no single-device path launches it.

Work counts: ``segment_reduce_work``, ``gspmm_work``, ``exchange_work`` and
``masked_update_work`` give the (operations, bytes) of one launch on a
plan (each input read once, each output written once), from the plan's
live counts (:func:`plan_counts`); ``chip_smoke.py``'s bounds and the cost
model (``repro_torch.obs.profile``) both price the kernels with them.

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

import dataclasses
import math
from typing import NamedTuple

import torch

from .. import cuda_build
from ..core import collectives as C
from ..cuda_build import check as _check
from ..cuda_build import on_card as _on_card
from ..cuda_build import stream as _stream

_IDENTITY = {"min": math.inf, "add": 0.0, "max": -math.inf}
_OP_CODE = {"min": 0, "add": 1, "max": 2}
_SCATTER = {"min": "amin", "add": "sum", "max": "amax"}
_REDUCE = {"min": "min", "add": "sum", "max": "max"}

#: segment_reduce's layout (:class:`SegmentLayout`). A tile owns up to
#: SEG_TILE_TARGETS consecutive targets of one partition and stages the
#: slot window of their runs: about SEG_TILE_SLOTS slots, plus the run
#: that crosses its end. A run of up to SEG_THREAD slots is reduced by a
#: thread of its tile, up to SEG_WARP by a warp of its tile, and beyond by
#: a block of its own (a unit). A gap of more than SEG_GAP slots between
#: two runs of a tile starts a new tile.
#: ``csrc/segment_reduce.cu`` takes up to 2048 targets a tile; these values
#: ran fastest of those ``tools/probe_kernels.py`` tries on the dblp plan.
SEG_TILE_SLOTS = 2048
SEG_TILE_TARGETS = 2048
SEG_THREAD = 32
SEG_WARP = 512
SEG_GAP = 32
#: A target's word holds its run's offset in its tile's window (the low 16
#: bits) and the run's length above them; this length marks a target that
#: a unit writes (``csrc/segment_reduce.cu`` kUnitLen).
SEG_UNIT = 0x7FFF

#: Kernel launches per wrapper since the last :func:`reset_launches`.
LAUNCHES = {"segment_reduce": 0, "masked_update": 0, "gspmm": 0,
            "exchange": 0}


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
            "replicated": (torch.bool, (k, v_max)),
            "local2global": (torch.int32, (k, v_max)),
            "csr_fill": (torch.int32, (k,))}
    for name in names:
        _check(getattr(plan, name), f"plan.{name}", *spec[name])


# ---------------------------------------------------------------------------
# segment_reduce
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SegmentLayout:
    """Who reduces what in ``segment_reduce``, for one plan (it reads only
    the plan's fields; messages are read per call).

    Target ``t = k·Vmax + v`` of partition ``k`` has the CSR run ``[start,
    end)``: ``end - 1 = min(last_slot, csr_fill - 1)``, ``start =
    run_start[last_slot]``, empty where that is empty or ``!vmask``. The
    targets fall into tiles of consecutive targets of one partition;
    ``tiles`` row ``i`` is (first target, targets, first flat slot of the
    window, window slots, first and end of its ``warp_targets``, first and
    end of its ``app_slots``), a flat slot being ``k·Emax + s``. A target's
    ``words`` entry is its run's offset in its tile's window | length <<
    16: length 0 for an empty run (the identity), up to ``thread_max`` for
    a thread of the tile, more for a warp of the tile (listed in
    ``warp_targets``), SEG_UNIT for a run a unit writes and the tile
    skips. ``units`` rows are (target, first flat slot, length, 0), by
    falling length, each a block's. A run that does not start at or after
    the end of every run of
    a lower target (never in a compiled or patched plan) is a unit too.
    The live append slots (``[csr_fill, e_max)``, ``emask``, target in
    ``[0, Vmax)`` and ``vmask``) of target ``t`` are ``app_slots[
    app_ptr[t]:app_ptr[t + 1]]``, flat slots by slot; ``app_ptr`` is
    ``[0]`` when there are none. ``window_cap`` is the widest window."""

    tiles: torch.Tensor         # [n_tiles, 8] int32
    words: torch.Tensor         # [K·Vmax] int32
    warp_targets: torch.Tensor  # [W] int32 flat targets, by tile
    units: torch.Tensor         # [n_units, 4] int32
    app_ptr: torch.Tensor       # [K·Vmax + 1] int32, or [1]
    app_slots: torch.Tensor     # [A] int32 flat slots
    window_cap: int
    tile_targets: int
    thread_max: int

    @property
    def n_tiles(self) -> int:
        return int(self.tiles.shape[0])

    @property
    def n_units(self) -> int:
        return int(self.units.shape[0])

    @property
    def n_append(self) -> int:
        return int(self.app_slots.numel())

    def stats(self) -> dict:
        """Counts to log: tiles, block units, warp runs, live append
        slots, the most append slots one target's writer walks, the
        widest window."""
        runs = torch.diff(self.app_ptr)
        return {"tiles": self.n_tiles, "block_units": self.n_units,
                "warp_runs": int(self.warp_targets.numel()),
                "append_slots": self.n_append,
                "longest_append_run": int(runs.max()) if runs.numel() else 0,
                "window_cap": self.window_cap}


def _ptr(counts: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sums with the total appended: [n] -> [n + 1]."""
    return torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])


def build_segment_layout(plan) -> SegmentLayout:
    """Build the :class:`SegmentLayout` of ``plan`` on its device, in plain
    PyTorch (host syncs: never inside a CUDA-graph capture)."""
    _check_plan(plan, "emask", "run_start", "edge_tgt", "last_slot", "vmask",
                "csr_fill")
    k, e_max, v_max = plan.k, plan.e_max, plan.v_max
    if k * e_max >= 2**31:
        raise ValueError("segment_reduce: K·Emax must fit in int32")
    dev = plan.device
    n_t = k * v_max
    # each target's CSR run [start, end), as the scan picks it at last_slot
    last = plan.last_slot.long()
    hi = torch.minimum(last, plan.csr_fill.long()[:, None] - 1)
    start = plan.run_start.long().gather(1, last.clamp(0, e_max - 1))
    ok = plan.vmask & (hi >= 0) & (last < e_max) & (start <= hi)
    start = torch.where(ok, start, 0)
    end = torch.where(ok, hi + 1, 0)
    length = end - start
    prev_end = torch.cat([end.new_zeros(k, 1),
                          end.cummax(dim=1).values[:, :-1]], 1)
    staged = ok & (start >= prev_end) & (length <= SEG_WARP)
    unit = (ok & ~staged).reshape(-1)
    start, end, length = (x.reshape(-1) for x in (start, end, length))

    # tiles: cut where a partition or a SEG_TILE_TARGETS block of targets
    # begins, where a gap of more than SEG_GAP slots opens between two
    # staged runs, and where the staged slots (gaps included) pass a
    # multiple of SEG_TILE_SLOTS; a window is then at most SEG_TILE_SLOTS
    # - 1 slots plus its first run
    st = torch.nonzero(staged.reshape(-1)).reshape(-1)
    s_start, s_end = start[st], end[st]
    newseg = torch.ones(st.numel(), dtype=torch.bool, device=dev)
    gap_end = torch.cat([s_end.new_zeros(1), s_end[:-1]])
    newseg[1:] = (st[1:] // v_max != st[:-1] // v_max) | \
        (s_start[1:] - gap_end[1:] > SEG_GAP)
    cpos = torch.cumsum(torch.where(newseg, s_end - s_start,
                                    s_end - gap_end), 0)
    chunk = (cpos - 1) // SEG_TILE_SLOTS
    cut_st = newseg.clone()
    cut_st[1:] |= chunk[1:] != chunk[:-1]
    tgt = torch.arange(n_t, device=dev)
    cut = (tgt % v_max) % SEG_TILE_TARGETS == 0
    cut[st[cut_st]] = True
    tile_of = torch.cumsum(cut.long(), 0) - 1
    t0 = torch.nonzero(cut).reshape(-1)
    n_tiles = int(t0.numel())
    size = torch.diff(t0, append=t0.new_full((1,), n_t))
    lo = torch.full((n_tiles,), e_max, dtype=torch.long, device=dev)
    lo.scatter_reduce_(0, tile_of[st], s_start, "amin")
    win_end = torch.zeros(n_tiles, dtype=torch.long, device=dev)
    win_end.scatter_reduce_(0, tile_of[st], s_end, "amax")
    lo = torch.where(win_end > 0, lo // 16 * 16, 0)     # 16-slot aligned
    win_end = torch.where(win_end > 0,
                          torch.clamp((win_end + 15) // 16 * 16, max=e_max),
                          0)

    words = torch.zeros(n_t, dtype=torch.long, device=dev)
    words[st] = (s_start - lo[tile_of[st]]) | (s_end - s_start) << 16
    words[unit] = SEG_UNIT << 16
    warp = st[s_end - s_start > SEG_THREAD]
    warp_ptr = _ptr(torch.bincount(tile_of[warp], minlength=n_tiles))

    # the live append slots, by (target, slot)
    slot = torch.arange(e_max, device=dev)[None, :]
    a_tgt = plan.edge_tgt.long()
    live = plan.emask & (slot >= plan.csr_fill.long()[:, None]) \
        & (a_tgt >= 0) & (a_tgt < v_max)
    live &= plan.vmask.gather(1, a_tgt.clamp(0, v_max - 1))
    ak, a_s = torch.nonzero(live, as_tuple=True)
    a_flat = ak * v_max + a_tgt[ak, a_s]
    order = torch.argsort(a_flat * e_max + a_s)
    app_slots = (ak * e_max + a_s)[order]
    if app_slots.numel():
        app_ptr = _ptr(torch.bincount(a_flat, minlength=n_t))
        app_first, app_end = app_ptr[t0], app_ptr[t0 + size]
    else:
        app_ptr = torch.zeros(1, dtype=torch.long, device=dev)
        app_first = app_end = torch.zeros_like(t0)

    # units: by falling length, then target
    uf = torch.nonzero(unit).reshape(-1)
    uf = uf[torch.argsort((e_max - length[uf]) * n_t + uf)]
    u_len = length[uf]
    i32 = torch.int32
    tiles = torch.stack([t0, size, (t0 // v_max) * e_max + lo, win_end - lo,
                         warp_ptr[:-1], warp_ptr[1:], app_first, app_end], 1)
    units = torch.stack([uf, (uf // v_max) * e_max + start[uf], u_len,
                         torch.zeros_like(uf)], 1)
    return SegmentLayout(
        tiles.to(i32).contiguous(), words.to(i32), warp.to(i32),
        units.to(i32).contiguous(), app_ptr.to(i32), app_slots.to(i32),
        int((win_end - lo).max()) if n_tiles else 0,
        int(size.max()) if n_tiles else 0, SEG_THREAD)


def segment_layout(plan) -> SegmentLayout:
    """The plan's :class:`SegmentLayout`, built once and kept on the plan:
    a plan made on the card (``compile_plan``, ``plan_from_numpy``) builds
    it then, any other (a ``dataclasses.replace``d plan) at its first
    call."""
    return plan._memo("_segment_layout", lambda: build_segment_layout(plan))


def segment_reduce(plan, messages: torch.Tensor,
                   combine: str = "min") -> torch.Tensor:
    """Per-target aggregates over the plan's CSR stream.

    messages [K, Emax] or [K, Emax, F] float32 -> aggregates [K, Vmax] /
    [K, Vmax, F] (identity at padding vertices). Masked slots, and CSR
    slots at or past ``csr_fill``, are the combine identity; live slots of
    the append region ``[csr_fill, e_max)`` are combined into their target
    on top. CUDA tensors launch the kernel over the plan's
    :func:`segment_layout` (on a plan not made on the card, built at its
    first call: do that outside any CUDA-graph capture); CPU tensors run
    :func:`segment_reduce_ref`.
    """
    if not _on_card(messages, plan.emask):
        return segment_reduce_ref(plan, messages, combine)
    squeeze = messages.ndim == 2
    k, e_max, v_max = plan.k, plan.e_max, plan.v_max
    f = 1 if squeeze else int(messages.shape[2])
    _check(messages, "messages", torch.float32,
           (k, e_max) if squeeze else (k, e_max, f))
    _check_plan(plan, "emask")
    lay = segment_layout(plan)
    out = torch.empty((k, v_max, f), dtype=torch.float32,
                      device=messages.device)
    vec = 4 if (e_max * f) % 4 == 0 and messages.data_ptr() % 16 == 0 \
        and plan.emask.data_ptr() % 4 == 0 else 1
    fn = cuda_build.entry("segment_reduce")
    ptrs = [t.data_ptr() for t in (messages, plan.emask, out, lay.tiles,
                                   lay.words, lay.warp_targets, lay.units,
                                   lay.app_ptr, lay.app_slots)]
    rc = fn(*ptrs, lay.n_tiles, lay.n_units, lay.window_cap,
            lay.tile_targets, lay.thread_max, lay.n_append, f,
            _OP_CODE[combine], vec, _stream())
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


#: gspmm's units: a run too long for a tile (a SegmentLayout unit) is cut
#: into chunks of up to GS_CHUNK slots, a block each.
GS_CHUNK = 2048


@dataclasses.dataclass(frozen=True)
class GspmmLayout:
    """``gspmm``'s reading of a plan: its :class:`SegmentLayout` (tiles,
    words, append slots), each slot's target and the units cut into
    chunks.

    ``slot_targets`` [K·Emax] int32 gives each slot of a run a tile stages
    (a thread's or a warp's) that run's target ``k·Vmax + v``, and -1 to
    every other slot (a tile's window, 16-slot aligned, may reach into its
    neighbours' runs: the kernel keeps only its own targets).

    ``chunks`` row ``b`` is (target, first flat slot, slots, unit), then
    (first chunk of the unit, chunks of the unit, 0, 0): the unit's chunks
    are consecutive rows, longest unit first, ``chunk_slots`` slots each
    but the last. A unit of more than one chunk has a partial row per chunk
    and an arrival counter, ``counters[unit]``, which is 0 between calls
    (the kernel counts arrivals with ``atomicInc``, which wraps it to 0 at
    the unit's last). ``window_cap`` is the most slots a block stages: a
    tile's window or a chunk."""

    seg: SegmentLayout
    slot_targets: torch.Tensor  # [K·Emax] int32
    chunks: torch.Tensor        # [n_chunks, 8] int32
    counters: torch.Tensor      # [n_units] int32, zero
    chunk_slots: int
    window_cap: int

    @property
    def n_chunks(self) -> int:
        return int(self.chunks.shape[0])

    @property
    def split(self) -> bool:
        """Whether some unit has more than one chunk (partial rows)."""
        return self.n_chunks > self.seg.n_units


def build_gspmm_layout(plan, seg: SegmentLayout | None = None
                       ) -> GspmmLayout:
    """List each staged slot's target and cut the units of ``seg`` (the
    plan's :func:`segment_layout` by default) into chunks of GS_CHUNK
    slots, in plain PyTorch on the plan's device (host syncs: never inside
    a CUDA-graph capture)."""
    seg = segment_layout(plan) if seg is None else seg
    size = GS_CHUNK
    units = seg.units.long()
    dev = units.device

    # the staged runs' slots: their tile's window start + offset
    tiles = seg.tiles.long()
    tile_of = torch.repeat_interleave(torch.arange(seg.n_tiles, device=dev),
                                      tiles[:, 1],
                                      output_size=seg.words.numel())
    words = seg.words.long()
    run = torch.nonzero(((words >> 16) > 0) & ((words >> 16) != SEG_UNIT))
    run = run.reshape(-1)
    run_len = words[run] >> 16
    n_slots = int(run_len.sum())
    which = torch.repeat_interleave(torch.arange(run.numel(), device=dev),
                                    run_len, output_size=n_slots)
    slot = (tiles[tile_of[run], 2] + (words[run] & 0xFFFF))[which] \
        + torch.arange(n_slots, device=dev) - _ptr(run_len)[which]
    slot_targets = torch.full((plan.k * plan.e_max,), -1, dtype=torch.int32,
                              device=dev)
    slot_targets[slot] = run[which].to(torch.int32)

    n = (units[:, 2] + size - 1) // size                 # chunks per unit
    first = _ptr(n)
    n_chunks = int(first[-1])
    unit = torch.repeat_interleave(torch.arange(seg.n_units, device=dev), n,
                                   output_size=n_chunks)
    i = torch.arange(n_chunks, device=dev) - first[unit]  # chunk in unit
    length = torch.clamp(units[unit, 2] - i * size, max=size)
    chunks = torch.stack([units[unit, 0], units[unit, 1] + i * size, length,
                          unit, first[unit], n[unit],
                          torch.zeros_like(unit), torch.zeros_like(unit)], 1)
    longest = int(length.max()) if n_chunks else 0
    return GspmmLayout(seg, slot_targets, chunks.to(torch.int32).contiguous(),
                       torch.zeros(seg.n_units, dtype=torch.int32,
                                   device=dev), size,
                       max(seg.window_cap, longest))


def gspmm_layout(plan) -> GspmmLayout:
    """The plan's :class:`GspmmLayout`, built once and kept on the plan,
    as :func:`segment_layout` is (with the plan on the card, else at its
    first call)."""
    return plan._memo("_gspmm_layout", lambda: build_gspmm_layout(plan))


def gspmm_mapping(f: int, vec4: bool) -> tuple[int, int]:
    """(lanes, vec): how ``csrc/gspmm.cu`` gathers an F-wide row. ``lanes``
    lanes share a slot, each loading ``vec`` floats of its row a pass
    (``vec`` 4 where ``vec4``: F % 4 == 0 and the planes 16-byte aligned);
    a row of more than lanes·vec floats takes several passes. F = 8 takes
    two lanes a slot, F = 128 a warp."""
    vec = 4 if vec4 else 1
    pieces = -(-f // vec)
    lanes = 1
    while lanes < 32 and lanes < pieces:
        lanes *= 2
    return lanes, vec


def gspmm(plan, feats: torch.Tensor, weights: torch.Tensor,
          combine: str = "add") -> torch.Tensor:
    """Gather · multiply · segment-reduce in one kernel.

    feats   [K, Vmax, F] (or [K, Vmax]) local feature rows, float32;
    weights [K, Emax] scalar per half-edge (``plan.edge_w``) or
            [K, Emax, F] per feature (a gathered edge channel);
    combine "add"/"sum", "max", or "mean" (sum over the clamped live
            degree)
    -> [K, Vmax, F] per-target aggregates (always rank 3), identity at
    padding vertices. CUDA tensors launch the kernel over the plan's
    :func:`gspmm_layout` (on a plan not made on the card, built at its
    first call: do that outside any CUDA-graph capture); CPU tensors run
    :func:`gspmm_ref`. Calls on one plan share its arrival counters: do
    not run two at once on different streams.
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
    _check(weights, "weights", torch.float32,
           (k, e_max, f) if weights.ndim == 3 else (k, e_max))
    _check_plan(plan, "edge_nbr", "emask")
    if k * max(e_max, v_max) >= 2**31:
        raise ValueError("gspmm: K·Emax and K·Vmax must fit in int32")
    out = _gspmm_launch(plan, gspmm_layout(plan), feats3, weights, combine)
    LAUNCHES["gspmm"] += 1
    return out


def _gspmm_launch(plan, lay: GspmmLayout, feats3: torch.Tensor,
                  weights: torch.Tensor, combine: str,
                  mapping: tuple[int, int] | None = None) -> torch.Tensor:
    """One launch of ``csrc/gspmm.cu`` over ``lay`` on checked arguments:
    the output, and the unit partials where a unit is split, allocated
    here. ``mapping`` is a (lanes, vec) of the kernel's GSPMM_SHAPES,
    :func:`gspmm_mapping`'s by default (``tools/probe_kernels.py`` times
    the others)."""
    out, args = _gspmm_args(plan, lay, feats3, weights, combine, mapping)
    rc = cuda_build.entry("gspmm")(*args)
    if rc != 0:
        raise RuntimeError(f"gspmm kernel launch failed: CUDA error {rc}")
    return out


def _gspmm_args(plan, lay: GspmmLayout, feats3: torch.Tensor,
                weights: torch.Tensor, combine: str,
                mapping: tuple[int, int] | None = None):
    """The output, allocated here, and the arguments of ``gspmm_f32``
    for :func:`_gspmm_launch`, which ``tools/probe_kernels.py`` also hands
    to another build of the kernel."""
    seg = lay.seg
    k, v_max, f = (int(n) for n in feats3.shape)
    per_feature = weights.ndim == 3
    out = torch.empty((k, v_max, f), dtype=torch.float32,
                      device=feats3.device)
    partials = torch.empty((lay.n_chunks, f), dtype=torch.float32,
                           device=feats3.device) if lay.split else out
    vec4 = f % 4 == 0 and feats3.data_ptr() % 16 == 0 and \
        (not per_feature or weights.data_ptr() % 16 == 0)
    lanes, vec = mapping or gspmm_mapping(f, vec4)
    # a tile's window starts 16 slots aligned within its partition, so a
    # 16-byte load of its slots is aligned only where Emax % 4 == 0 too
    stage4 = plan.e_max % 4 == 0 and plan.edge_nbr.data_ptr() % 16 == 0 \
        and plan.emask.data_ptr() % 4 == 0 and \
        lay.slot_targets.data_ptr() % 16 == 0 and \
        (per_feature or weights.data_ptr() % 16 == 0)
    ptrs = [t.data_ptr() for t in (feats3, weights, plan.edge_nbr, plan.emask,
                                   out, seg.tiles, seg.words,
                                   lay.slot_targets, lay.chunks, seg.app_ptr,
                                   seg.app_slots, partials, lay.counters)]
    return out, (*ptrs, seg.n_tiles, lay.n_chunks, lay.window_cap,
                 seg.tile_targets, seg.n_append, plan.e_max, v_max, f,
                 int(per_feature), _OP_CODE[combine], lanes, vec,
                 int(stage4), _stream())


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


def exchange_ref(plan, values: torch.Tensor, combine: str = "min", *,
                 update=masked_update_ref) -> torch.Tensor:
    """Plain version of :func:`exchange`: the reference's chain (its
    ``runtime._exchange``). The live replicated slots are scattered into a
    global frontier ``glob [V(, F)]`` (``scatter_reduce_``: an add sums in
    an order that changes from call to call), then ``update`` gathers it
    back: :func:`masked_update_ref`, or :func:`masked_update`, with which
    the engine ran this chain on the card before :func:`exchange`."""
    return update(values, _frontier(plan, values, combine),
                  plan.local2global, plan.vmask, plan.replicated, combine)


def _frontier(plan, values: torch.Tensor, combine: str) -> torch.Tensor:
    """The global frontier ``glob [V(, F)]``: the live replicated slots of
    ``values`` scatter-combined into their vertices from the identity."""
    ident = _IDENTITY[combine]
    mask = plan.vmask & plan.replicated
    send = torch.where(mask[:, :, None] if values.ndim == 3 else mask,
                       values, ident)
    tail = tuple(values.shape[2:])
    glob = torch.full((plan.n_vertices,) + tail, ident, dtype=torch.float32,
                      device=values.device)
    flat_send = send.reshape((-1,) + tail)
    idx = plan.index64("local2global").reshape(-1)
    if tail:
        idx = idx.reshape(-1, 1).expand(-1, *tail)
    # add identity is 0.0, so the masked send scatters exactly
    glob.scatter_reduce_(0, idx, flat_send, _SCATTER[combine])
    return glob


def exchange_sharded(plan, values: torch.Tensor, combine: str = "min",
                     group=None, *, update=masked_update) -> torch.Tensor:
    """The replica exchange of a superstep across the ranks of ``group``,
    on a rank's block of the plan (``plan.shard_plan``): the block's live
    replicated slots are scatter-combined into a global frontier ``glob
    [V(, F)]`` (plain torch, as the reference computes it outside any
    kernel), ``glob`` is all-reduced across the ranks with the combine's
    reduce, and ``update`` gathers it back: :func:`masked_update`, the
    glob-form kernel, which runs :func:`masked_update_ref` on CPU tensors;
    ``update=masked_update_ref`` is the plain version throughout.

    values [K_loc, Vmax(, F)] float32 -> same shape."""
    glob = _frontier(plan, values, combine)
    C.all_reduce_(glob, _REDUCE[combine], group)
    return update(values, glob, plan.local2global, plan.vmask,
                  plan.replicated, combine)


# ---------------------------------------------------------------------------
# exchange
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ExchangeLayout:
    """Who combines what in :func:`exchange`, for one plan (it reads only
    the plan's masks and ``local2global``; values are read per call).

    A group is a global vertex with live replicated slots (``vmask &
    replicated``): group ``i``'s slots are ``slots[ptr[i]:ptr[i + 1]]``,
    flat ``k·Vmax + v``, in ascending ``k``, the order in which the kernel
    combines them. Groups are listed by falling size, then by vertex, so
    neighbouring threads hold groups of one size (hubs beside hubs, pairs
    beside pairs), the largest first. Private live slots and padding are
    not listed: the kernel reads their masks."""

    ptr: torch.Tensor           # [G + 1] int32
    slots: torch.Tensor         # [R] int32 flat slots, by group, ascending k
    largest: int                # slots of the largest group

    @property
    def n_groups(self) -> int:
        return int(self.ptr.numel()) - 1

    @property
    def n_slots(self) -> int:
        return int(self.slots.numel())

    def stats(self) -> dict:
        """Counts to log: groups, replicated slots, the largest group, and
        groups by size."""
        sizes = torch.bincount(torch.diff(self.ptr.long()))
        return {"groups": self.n_groups, "replicated_slots": self.n_slots,
                "largest_group": self.largest,
                "groups_by_size": {int(m): int(c) for m, c in
                                   enumerate(sizes.tolist()) if c}}


def build_exchange_layout(plan) -> ExchangeLayout:
    """Build the :class:`ExchangeLayout` of ``plan`` on its device, in plain
    PyTorch (host syncs: never inside a CUDA-graph capture)."""
    _check_plan(plan, "vmask", "replicated", "local2global")
    n_slots, n = plan.k * plan.v_max, plan.n_vertices
    if n_slots >= 2**31:
        raise ValueError("exchange: K·Vmax must fit in int32")
    slots = torch.nonzero((plan.vmask & plan.replicated).reshape(-1))
    slots = slots.reshape(-1)                   # by k, then v
    vert = plan.local2global.reshape(-1)[slots].long()
    if slots.numel() and not bool(((vert >= 0) & (vert < n)).all()):
        raise ValueError("exchange: a live replicated slot's local2global "
                         "is outside [0, n_vertices)")
    size = torch.bincount(vert, minlength=n)
    groups = torch.nonzero(size).reshape(-1)
    largest = int(size.max()) if slots.numel() else 0
    groups = groups[torch.argsort((largest - size[groups]) * n + groups)]
    rank = torch.empty(n, dtype=torch.long, device=slots.device)
    rank[groups] = torch.arange(groups.numel(), device=slots.device)
    slots = slots[torch.argsort(rank[vert] * n_slots + slots)]
    return ExchangeLayout(_ptr(size[groups]).to(torch.int32),
                          slots.to(torch.int32), largest)


def exchange_layout(plan) -> ExchangeLayout:
    """The plan's :class:`ExchangeLayout`, built once and kept on the plan,
    as :func:`segment_layout` is (with the plan on the card, else at its
    first call)."""
    return plan._memo("_exchange_layout", lambda: build_exchange_layout(plan))


def exchange(plan, values: torch.Tensor, combine: str = "min"
             ) -> torch.Tensor:
    """The replica exchange of a superstep: every live replicated slot
    takes the combine of its vertex's live replicated slots (ascending
    partition, from the identity), private live slots keep their value,
    padding gets the identity.

    values [K, Vmax(, F)] float32 -> same shape. CUDA tensors launch one
    kernel over the plan's :func:`exchange_layout` (on a plan not made on
    the card, built at its first call: do that outside any CUDA-graph
    capture); CPU tensors run :func:`exchange_ref`.
    """
    if not _on_card(values, plan.vmask):
        return exchange_ref(plan, values, combine)
    k, v_max = plan.k, plan.v_max
    f = 1 if values.ndim == 2 else int(values.shape[2])
    _check(values, "values", torch.float32,
           (k, v_max) if values.ndim == 2 else (k, v_max, f))
    _check_plan(plan, "vmask", "replicated")
    lay = exchange_layout(plan)
    out = torch.empty_like(values)
    vec = values.data_ptr() % 16 == 0 and plan.vmask.data_ptr() % 4 == 0 \
        and plan.replicated.data_ptr() % 4 == 0
    ptrs = [t.data_ptr() for t in (values, plan.vmask, plan.replicated,
                                   lay.ptr, lay.slots, out)]
    rc = cuda_build.entry("replica_exchange")(
        *ptrs, lay.n_groups, k * v_max, f, _OP_CODE[combine], int(vec),
        _stream())
    if rc != 0:
        raise RuntimeError(f"exchange kernel launch failed: CUDA error {rc}")
    LAUNCHES["exchange"] += 1
    return out


def exchange_layout_ref(plan, values: torch.Tensor, combine: str = "min"
                        ) -> torch.Tensor:
    """The kernel's reading of the plan's :func:`exchange_layout` in plain
    PyTorch: each group's values gathered in layout order and folded from
    the identity one slot at a time, the result scattered back to the
    group's slots; private live slots copied and padding set to the
    identity. The same float32 operations in the same order as
    ``csrc/replica_exchange.cu``."""
    lay = exchange_layout(plan)
    ident = _IDENTITY[combine]
    op = {"min": torch.minimum, "add": torch.add, "max": torch.maximum}[
        combine]
    tail = tuple(values.shape[2:])
    flat = values.reshape((-1,) + tail)
    vmask = plan.vmask.reshape(-1)
    out = torch.where(vmask[:, None] if tail else vmask, flat, ident)
    ptr, slots = lay.ptr.long(), lay.slots.long()
    size = torch.diff(ptr)
    acc = torch.full((lay.n_groups,) + tail, ident, dtype=torch.float32,
                     device=values.device)
    for j in range(lay.largest):                # the j-th slot of each group
        has = size > j
        acc[has] = op(acc[has], flat[slots[ptr[:-1][has] + j]])
    group = torch.repeat_interleave(torch.arange(lay.n_groups,
                                                 device=values.device),
                                    size, output_size=lay.n_slots)
    out[slots] = acc[group]
    return out.view(values.shape)


# ---------------------------------------------------------------------------
# Work counts: the least work of one launch, for the kernels' bounds
# (``chip_smoke.py``) and the cost model (``repro_torch.obs.profile``)
# ---------------------------------------------------------------------------

class PlanCounts(NamedTuple):
    """The live counts of a plan that the kernels' work depends on."""
    live: int            # live half-edges (emask)
    append_live: int     # live half-edges of the append region
    nbr_rows: int        # distinct live neighbour rows (partition, slot)
    live_slots: int      # live vertex slots (vmask)
    private: int         # live slots not replicated
    rep_slots: int       # live replicated slots
    rep_groups: int      # distinct vertices with a live replicated slot


def plan_counts(plan) -> PlanCounts:
    """The plan's :class:`PlanCounts`, read once (a few host reads) and
    kept on the plan."""
    def make():
        slot = torch.arange(plan.e_max, device=plan.device)[None, :]
        base = torch.arange(plan.k, device=plan.device)[:, None] * plan.v_max
        rep = plan.vmask & plan.replicated
        return PlanCounts(
            live=int(plan.emask.sum()),
            append_live=int((plan.emask
                             & (slot >= plan.csr_fill[:, None])).sum()),
            nbr_rows=int(torch.unique(
                (base + plan.edge_nbr.long())[plan.emask]).numel()),
            live_slots=int(plan.vmask.sum()),
            private=int((plan.vmask & ~plan.replicated).sum()),
            rep_slots=int(rep.sum()),
            rep_groups=int(torch.unique(plan.local2global[rep]).numel()))
    return plan._memo("_plan_counts", make)


def segment_reduce_work(plan, f: int = 1) -> tuple[int, int]:
    """(operations, bytes) of one :func:`segment_reduce` launch at width
    ``f``: each live message read once and combined once, the masks and
    per-target indices read once, each aggregate written once."""
    c = plan_counts(plan)
    kv, ke = plan.k * plan.v_max, plan.k * plan.e_max
    nbytes = (4 * f * c.live + 2 * ke + 5 * kv + 4 * plan.k
              + 4 * c.append_live + 4 * f * kv)
    return f * c.live, nbytes


def gspmm_work(plan, f: int, per_feature: bool = False) -> tuple[int, int]:
    """(operations, bytes) of one :func:`gspmm` launch at width ``f``: per
    live half-edge its neighbour index and its weight (4·F bytes of them
    with per-feature weights); per slot the two masks; per target
    ``last_slot`` and ``vmask``; per live append slot its target; each
    distinct live feature row read once; each output row written once.
    Operations: a multiply and a combine per feature per live half-edge."""
    c = plan_counts(plan)
    kv, ke = plan.k * plan.v_max, plan.k * plan.e_max
    weight = 4 * f if per_feature else 4
    nbytes = ((4 + weight) * c.live + 2 * ke + 5 * kv + 4 * plan.k
              + 4 * c.append_live + 4 * f * c.nbr_rows + 4 * f * kv)
    return 2 * f * c.live, nbytes


def exchange_work(plan, f: int = 1) -> tuple[int, int]:
    """(operations, bytes) of one :func:`exchange` launch at width ``f``:
    each live slot's value read once, each group's slot indices (and its
    pointer) read once, both masks read once and every slot written
    once."""
    c = plan_counts(plan)
    kv = plan.k * plan.v_max
    nbytes = (4 * f * c.live_slots + 4 * (c.rep_slots + c.rep_groups + 1)
              + 2 * kv + 4 * f * kv)
    return 0, nbytes


def masked_update_work(plan, f: int = 1) -> tuple[int, int]:
    """(operations, bytes) of one :func:`masked_update` launch at width
    ``f`` on ``plan`` (a rank's block): private live slots read state,
    replicated live slots read their index and their vertex's glob row
    (each distinct row once), both masks read and every slot written."""
    c = plan_counts(plan)
    kv = plan.k * plan.v_max
    nbytes = (4 * f * c.private + 4 * c.rep_slots + 4 * f * c.rep_groups
              + 2 * kv + 4 * f * kv)
    return 0, nbytes

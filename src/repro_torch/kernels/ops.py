"""Hopper kernels for the paper's standalone hot spots and the Mamba scan,
with their plain PyTorch versions (``ref``).

``lane_cumsum``
    Inclusive cumsum down the rows of a tall [S, K] array: DFEP's step-1
    rank cumsum. CUDA C++ in ``csrc/lane_cumsum.cu``: one pass with
    decoupled look-back (each block scans a tile of rows held in registers
    from 16-byte loads, publishes its per-column aggregate, sums its
    predecessors' up to the nearest inclusive prefix, and writes), so the
    input is read once. :func:`cumsum_vec` picks the load width; the
    kernel's source gives the size of the zeroed status scratch
    (``lane_cumsum_scratch_words``). Replaces
    ``repro/kernels/lane_cumsum.py::lane_cumsum``.

``frontier_min``
    ETSCH aggregation: the masked min over the partition axis of a [K, V]
    state. CUDA C++ in ``csrc/frontier_min.cu``: a thread owns VEC
    consecutive vertex columns (:func:`frontier_min_vec` picks 4 in
    float32, 8 in bfloat16, or 1 from V and the pointers' alignment),
    loads 16 rows of mask words at once, then the state vectors those rows
    need in 16-byte loads, 8 rows at a time, then compares.
    Replaces ``repro/kernels/frontier_min.py::frontier_min``.

``minplus_sweep``
    One undirected min-plus relaxation sweep over an edge list: the ETSCH
    local phase and the vertex-centric references' round. CUDA C++ in
    ``csrc/minplus_sweep.cu``: one launch that pulls, over a target-sorted
    :class:`MinplusLayout` of half-edges built once per edge list
    (:func:`minplus_layout`); each output row is written once, with no
    atomics. Replaces ``repro/kernels/minplus_sweep.py::minplus_sweep``.

``selective_scan``
    The Mamba-1 forward scan with an initial and a final state: every
    layer of LM prefill and of every decode step. CUDA C++ in
    ``csrc/selective_scan.cu``: a thread keeps N / L states of one channel
    in registers (L, the lanes per channel, is the kernel's own rule:
    ``selective_scan_lanes``), one ex2 per state and step,
    chunks staged with ``cp.async`` into two buffers; decode (S = 1) has
    its own unstaged kernel. Under autograd it also writes the state at
    the start of every SCAN_CHUNK steps. Replaces
    ``repro/kernels/selective_scan.py::selective_scan``.

``selective_scan_bwd``
    The scan's gradient: every SSM layer of a training step's backward.
    CUDA C++ in ``csrc/selective_scan_bwd.cu``: a thread owns 4 states of
    one channel, walks the chunks from the last, recomputes each chunk's
    states from its saved one with the forward's own arithmetic, then its
    steps backwards; dB/dC are reduced over a block's channels, then one
    atomicAdd a block. Replaces no TPU kernel: the reference
    differentiates its chunked scan (``repro/models/ssm.py``) with JAX's
    autodiff, and its Pallas kernel is forward-only.

Dispatch: a wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors; a mix raises, and there is no fallback from one to
the other. Each launch adds one to :data:`LAUNCHES`. A dtype a kernel does
not take raises ``ValueError``.

The scan's two wrappers also take ``meta`` tensors, the dry run's
stand-ins (``launch/dryrun.py``): they return empty outputs of the card
path's shapes and dtypes and run nothing, neither kernel nor plain
version. On every device each call adds its ``selective_scan_work`` /
``selective_scan_bwd_work`` count to the active ``roofline.count.Counter``
as one launch, and no op inside it is counted.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import cuda_build
from ..cuda_build import check as _check
from ..cuda_build import on_card as _on_card
from ..cuda_build import stream as _stream
from ..roofline import count as _count
from . import ref

#: Kernel launches per wrapper since the last :func:`reset_launches`.
LAUNCHES = {"lane_cumsum": 0, "frontier_min": 0, "minplus_sweep": 0,
            "selective_scan": 0, "selective_scan_bwd": 0}

#: Vertex columns a frontier_min thread may own, widest first.
MIN_VEC_WIDTHS = (8, 4, 1)
_CUMSUM_DTYPES = {torch.int32: 0, torch.float32: 1}
_MIN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: State widths the scan kernels take.
SCAN_STATES = (4, 8, 16, 32)
#: Steps between two chunk states the scan's forward keeps for its
#: backward (``kChunk`` of ``csrc/selective_scan.cu`` and
#: ``csrc/selective_scan_bwd.cu``, checked against both on the card).
SCAN_CHUNK = 16
#: Rows of state one minplus_sweep tile block owns, smallest first: a
#: layout takes the largest whose tiles hold at most MINPLUS_TILE_EDGES
#: half-edges on average (``csrc/minplus_sweep.cu`` takes up to 2048).
MINPLUS_TILE_ROWS = (256, 512, 1024, 2048)
MINPLUS_TILE_EDGES = 2048
#: In-degree up to which a row is pulled by a thread of its tile (the .cu
#: keeps 8 loads in flight); up to MINPLUS_WARP by a warp of its own, up to
#: MINPLUS_HUB by a block of its own, and beyond (a hub) by a cluster of
#: blocks.
MINPLUS_SHORT = 8
MINPLUS_WARP = 512
MINPLUS_HUB = 4096
#: Bits of an entry's second word that hold the row within its tile; the
#: in-degree sits above them. The layout carries it to the kernel.
MINPLUS_LOCAL_BITS = 12
#: minplus_sweep launches by state rows since the last reset_launches.
MINPLUS_LAUNCHES_BY_ROWS: dict[int, int] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    MINPLUS_LAUNCHES_BY_ROWS.clear()


def _dtype_code(t: torch.Tensor, table: dict, kernel: str) -> int:
    if t.dtype not in table:
        raise ValueError(f"{kernel}: dtype {t.dtype} is not supported "
                         f"(takes {', '.join(map(str, table))})")
    return table[t.dtype]


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def cumsum_vec(k: int, x_ptr: int, out_ptr: int) -> int:
    """Columns a lane_cumsum thread loads at once from an [S, k] array at
    ``x_ptr`` into one at ``out_ptr``: 4 (one 16-byte load) when k % 4 == 0
    and both pointers are 16-byte aligned, else 1."""
    return 4 if k % 4 == 0 and x_ptr % 16 == 0 and out_ptr % 16 == 0 else 1


def frontier_min_vec(v: int, elem_bytes: int, state_ptr: int,
                     member_ptr: int, out_ptr: int) -> int:
    """Vertex columns a frontier_min thread owns: the widest of
    MIN_VEC_WIDTHS whose state load is at most 16 bytes (4 in float32, 8
    in bfloat16), that divides ``v``, and whose loads the pointers allow
    (state and out aligned to ``width · elem_bytes``, member to
    ``width``); 1 always fits."""
    for w in MIN_VEC_WIDTHS:
        size = w * elem_bytes
        if size <= 16 and v % w == 0 and state_ptr % size == 0 \
                and out_ptr % size == 0 and member_ptr % w == 0:
            return w
    return 1


def lane_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along axis 0 of x [S, K] (int32 or float32), in x's
    dtype. CUDA tensors launch the kernel; CPU tensors run
    :func:`ref.cumsum_lanes`. int32 is exact; float32 sums in another order
    than a sequential scan."""
    code = _dtype_code(x, _CUMSUM_DTYPES, "lane_cumsum")
    if x.ndim != 2:
        raise ValueError(f"lane_cumsum: expected [S, K], got {tuple(x.shape)}")
    if not _on_card(x):
        return ref.cumsum_lanes(x)
    s, k = (int(n) for n in x.shape)
    _check(x, "x", x.dtype, (s, k))
    out = torch.empty_like(x)
    if s == 0 or k == 0:
        return out
    vec = cumsum_vec(k, x.data_ptr(), out.data_ptr())
    words = cuda_build.query("lane_cumsum_scratch_words")(s, k, vec)
    # zeroed on every call (one memset on the stream): the tile counter and
    # the look-back's status flags start clean, in a CUDA graph replay too
    scratch = torch.zeros(words, dtype=torch.int64, device=x.device)
    rc = cuda_build.entry("lane_cumsum")(x.data_ptr(), out.data_ptr(),
                                         scratch.data_ptr(), s, k, vec, code,
                                         _stream())
    _launched("lane_cumsum", rc)
    return out


def frontier_min(state: torch.Tensor, member: torch.Tensor) -> torch.Tensor:
    """Masked min over axis 0: state [K, V] (float32 or bfloat16), member
    [K, V] bool -> [V] in state's dtype, ``+inf`` where no row is a member.
    Exact. CUDA tensors launch the kernel; CPU tensors run
    :func:`ref.kreduce_min`."""
    code = _dtype_code(state, _MIN_DTYPES, "frontier_min")
    if state.ndim != 2:
        raise ValueError(f"frontier_min: expected state [K, V], got "
                         f"{tuple(state.shape)}")
    if not _on_card(state, member):
        return ref.kreduce_min(state, member)
    k, v = (int(n) for n in state.shape)
    _check(state, "state", state.dtype, (k, v))
    _check(member, "member", torch.bool, (k, v))
    out = torch.empty(v, dtype=state.dtype, device=state.device)
    vec = frontier_min_vec(v, state.element_size(), state.data_ptr(),
                           member.data_ptr(), out.data_ptr())
    rc = cuda_build.entry("frontier_min")(state.data_ptr(), member.data_ptr(),
                                          out.data_ptr(), k, v, code, vec,
                                          _stream())
    _launched("frontier_min", rc)
    return out


@dataclasses.dataclass(frozen=True)
class MinplusLayout:
    """The half-edges of an edge list grouped by target row, for
    ``minplus_sweep``'s pull. It depends on ``src``/``dst`` alone, so any
    mask works with it (read per call through the edge id).

    The rows ``[0, n_rows)`` fall into ``groups`` equal groups (ETSCH's
    partitions; 1 for a whole graph), and every edge stays inside one
    group. A group is cut into tiles of ``tile_rows`` rows; tile ``t``'s
    entries ``entries[tile_ptr[2t]:tile_ptr[2t+2]]`` are its short rows
    (in-degree up to MINPLUS_SHORT), then, from ``tile_ptr[2t+1]``, its
    other rows, each part by row. An entry is (first half-edge, row within
    the tile | in-degree << ``local_bits``), the in-degree 0 for a row
    that is not short: those rows are ``rows``' (row, first, end, 0), the
    ``counts`` = (hubs, large, medium) of each kind in that order, each by
    falling in-degree. ``loops_left_out`` counts the in-range self-loops
    the layout leaves out: their candidate ``dist[r] + cost`` lowers row
    ``r`` only at a negative cost, for which :func:`minplus_sweep` builds
    a layout that keeps them. With ``replicas`` S the state holds S
    copies of every group, row ``k·V + v`` of the layout standing for
    ``(k·S + s)·V + v`` (multi-source SSSP's [K, S, V]), all under the
    same edges and mask."""

    n_rows: int
    groups: int
    n_edges: int
    tile_rows: int
    local_bits: int
    replicas: int
    loops_left_out: int
    half_edges: torch.Tensor   # [H, 2] int32 (other row, edge id)
    entries: torch.Tensor      # [A, 2] int32
    tile_ptr: torch.Tensor     # [2·n_tiles + 1] int32
    rows: torch.Tensor         # [hubs + large + medium, 4] int32
    counts: tuple              # (hubs, large, medium)
    edges_at: tuple            # (src, dst) data pointers it was built from

    @property
    def group_rows(self) -> int:
        return self.n_rows // self.groups

    @property
    def n_tiles(self) -> int:
        return self.groups * -(-self.group_rows // self.tile_rows)

    def with_replicas(self, replicas: int) -> "MinplusLayout":
        """The same layout over ``replicas`` copies of every group."""
        return dataclasses.replace(self, replicas=int(replicas))

    def built_from(self, src: torch.Tensor, dst: torch.Tensor) -> bool:
        return self.edges_at == (src.data_ptr(), dst.data_ptr(),
                                 int(src.numel()))

    def replicate(self, src, dst, mask):
        """The edge list over all replicas as plain arrays (the layout's
        meaning, for the plain version)."""
        if self.replicas == 1:
            return src, dst, mask
        v, s_n = self.group_rows, self.replicas
        shift = ((src.long() // v) * (s_n - 1))[None, :] + torch.arange(
            s_n, device=src.device)[:, None]
        return ((src.long()[None, :] + shift * v).reshape(-1),
                (dst.long()[None, :] + shift * v).reshape(-1),
                mask[None, :].expand(s_n, -1).reshape(-1))


def minplus_tile_rows(n_rows: int, n_half_edges: int) -> int:
    """The largest of MINPLUS_TILE_ROWS whose tiles average at most
    MINPLUS_TILE_EDGES half-edges (the smallest if none does)."""
    fits = [t for t in MINPLUS_TILE_ROWS
            if t * n_half_edges <= MINPLUS_TILE_EDGES * max(n_rows, 1)]
    return fits[-1] if fits else MINPLUS_TILE_ROWS[0]


def minplus_row_kind(degree: torch.Tensor) -> torch.Tensor:
    """0 short, 1 medium, 2 large, 3 hub, by in-degree (> 0)."""
    return ((degree > MINPLUS_SHORT).long() + (degree > MINPLUS_WARP).long()
            + (degree > MINPLUS_HUB).long())


def minplus_layout(src: torch.Tensor, dst: torch.Tensor, n_rows: int,
                   groups: int = 1, loops: bool = False) -> MinplusLayout:
    """Build the :class:`MinplusLayout` of the edge list ``src``/``dst``
    [E] (int32 rows in [0, n_rows)) on their device, in plain PyTorch.
    Edge ``e`` = (u, v) gives the half-edges (v <- u) and, unless u == v,
    (u <- v); a self-loop (u == v) gives its one half-edge only with
    ``loops``; an edge with an endpoint outside [0, n_rows) gives none (the
    sweep ignores it). Raises if an edge joins two groups."""
    dev = src.device
    if n_rows % groups:
        raise ValueError(f"minplus_layout: {n_rows} rows do not split into "
                         f"{groups} groups")
    v = n_rows // groups
    e = int(src.numel())
    s, d = src.reshape(-1).long(), dst.reshape(-1).long()
    ok = (s >= 0) & (s < n_rows) & (d >= 0) & (d < n_rows)
    if groups > 1 and bool((ok & (s // v != d // v)).any()):
        raise ValueError("minplus_layout: an edge joins two groups")
    back = ok & (s != d)
    fwd = ok if loops else back
    eid = torch.arange(e, device=dev)
    tgt = torch.cat([d[fwd], s[back]])
    other = torch.cat([s[fwd], d[back]])
    ids = torch.cat([eid[fwd], eid[back]])
    order = torch.argsort(tgt * max(e, 1) + ids)   # unique keys
    tgt, other, ids = tgt[order], other[order], ids[order]
    deg = torch.bincount(tgt, minlength=n_rows)
    first = torch.cumsum(deg, 0) - deg
    tile = minplus_tile_rows(n_rows, int(tgt.numel()))
    per_group = -(-v // tile)
    rows = torch.nonzero(deg).reshape(-1)
    rdeg = deg[rows]
    kind = minplus_row_kind(rdeg)
    # the tiles' entries: short rows, then the others, each part by row
    tile_of = (rows // v) * per_group + (rows % v) // tile
    local = (rows % v) % tile
    part = (kind > 0).long()
    order = torch.argsort((tile_of * 2 + part) * tile + local)
    per_part = torch.bincount(tile_of * 2 + part,
                              minlength=2 * groups * per_group)
    tile_ptr = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                          torch.cumsum(per_part, 0)])
    packed = local | (torch.where(kind == 0, rdeg, 0) << MINPLUS_LOCAL_BITS)
    entries = torch.stack([first[rows], packed], 1)[order]
    # the units' rows: hubs, then large, then medium, each by falling
    # in-degree, then by row
    unit = torch.nonzero(kind > 0).reshape(-1)
    unit = unit[torch.argsort(((3 - kind[unit]) * (e + 1) + e - rdeg[unit])
                              * (n_rows + 1) + rows[unit])]
    ur = rows[unit]
    n_kind = torch.bincount(kind, minlength=4).tolist()
    i32 = torch.int32
    return MinplusLayout(
        n_rows, groups, e, tile, MINPLUS_LOCAL_BITS, 1,
        0 if loops else int((ok & (s == d)).sum()),
        torch.stack([other, ids], 1).to(i32).contiguous(),
        entries.to(i32).contiguous(), tile_ptr.to(i32),
        torch.stack([ur, first[ur], first[ur] + deg[ur],
                     torch.zeros_like(ur)], 1).to(i32).contiguous(),
        (n_kind[3], n_kind[2], n_kind[1]),
        (src.data_ptr(), dst.data_ptr(), e))


def minplus_sweep(dist: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                  mask: torch.Tensor, cost: float = 1.0, *,
                  layout: MinplusLayout | None = None) -> torch.Tensor:
    """One undirected min-plus relaxation sweep, Jacobi: dist [V] float32,
    src/dst [E] int32 in [0, V), mask [E] bool -> [V]. Bit-identical to
    :func:`ref.minplus_relax`. ``layout``, built from this ``src``/``dst``
    by :func:`minplus_layout`, saves building it on each call; with
    ``layout.replicas`` S > 1, dist is the [S·n_rows] state of
    :class:`MinplusLayout` and src/dst/mask are one replica's edges. CUDA
    tensors launch the kernel (building a layout first when none is
    given, or when a negative cost needs the self-loops the layout left
    out); CPU tensors run the plain version."""
    _dtype_code(dist, {torch.float32: 0}, "minplus_sweep")
    if layout is not None and not layout.built_from(src, dst):
        raise ValueError("minplus_sweep: the layout was built from another "
                         "edge list")
    if not _on_card(dist, src, dst, mask):
        if layout is not None:
            src, dst, mask = layout.replicate(src, dst, mask)
        return ref.minplus_relax(dist, src, dst, mask, cost)
    e = int(src.numel())
    _check(src, "src", torch.int32, (e,))
    _check(dst, "dst", torch.int32, (e,))
    _check(mask, "mask", torch.bool, (e,))
    if layout is None:
        layout = minplus_layout(src, dst, int(dist.numel()), loops=cost < 0)
    elif cost < 0 and layout.loops_left_out:
        layout = minplus_layout(src, dst, layout.n_rows, layout.groups,
                                loops=True).with_replicas(layout.replicas)
    rows = layout.n_rows * layout.replicas
    _check(dist, "dist", torch.float32, (rows,))
    out = torch.empty_like(dist)
    vec = 4 if layout.group_rows % 4 == 0 and dist.data_ptr() % 16 == 0 \
        and out.data_ptr() % 16 == 0 else 1
    rc = cuda_build.entry("minplus_sweep")(
        dist.data_ptr(), out.data_ptr(), mask.data_ptr(),
        layout.half_edges.data_ptr(), layout.entries.data_ptr(),
        layout.tile_ptr.data_ptr(), layout.rows.data_ptr(), *layout.counts,
        layout.group_rows, layout.groups, layout.tile_rows,
        layout.local_bits, layout.replicas, float(cost), vec, _stream())
    _launched("minplus_sweep", rc)
    MINPLUS_LAUNCHES_BY_ROWS[rows] = MINPLUS_LAUNCHES_BY_ROWS.get(rows, 0) + 1
    return out


def _scan_shapes(x, a) -> dict:
    """The shape each scan argument must have, by name."""
    bsz, s, d_in = (int(n) for n in x.shape)
    n = int(a.shape[1])
    return {"x": (bsz, s, d_in), "dt": (bsz, s, d_in), "b": (bsz, s, n),
            "c": (bsz, s, n), "a": (d_in, n), "d_skip": (d_in,),
            "h0": (bsz, d_in, n)}


def _scan_chunks(s: int) -> int:
    return -(-s // SCAN_CHUNK)


def selective_scan_work(b: int, s: int, d: int, n: int, h0: bool,
                        states: bool = False) -> tuple[int, int]:
    """(operations, bytes) of one :func:`selective_scan` launch at
    [B, S, Di] × N: x, dt, B, C, A and D read once, h0 read where it is
    given, y and h_last written once, and under ``states`` (autograd) the
    chunk states [B, ceil(S / SCAN_CHUNK), Di, N] written once; 6 float32
    operations per state element and step (one of them the exp)."""
    nbytes = 4 * (3 * b * s * d + 2 * b * s * n + d * n + d
                  + b * d * n * (2 if h0 else 1))
    if states:
        nbytes += 4 * b * _scan_chunks(s) * d * n
    return 6 * b * s * d * n, nbytes


def selective_scan_bwd_work(b: int, s: int, d: int, n: int
                            ) -> tuple[int, int]:
    """(operations, bytes) of one :func:`selective_scan_bwd` launch at
    [B, S, Di] × N: x, dt, B, C, dy, A, D, the chunk states and dh_last
    read once, the seven gradients written once; per state element and
    step the forward's 6 operations again (the recompute from the chunk
    states) and six fused multiply-adds of the backward walk (12)."""
    nbytes = 4 * (5 * b * s * d + 4 * b * s * n + 2 * d * n + 2 * d
                  + b * _scan_chunks(s) * d * n + 2 * b * d * n)
    return 18 * b * s * d * n, nbytes


def _on_meta(*tensors) -> bool:
    """True when every tensor is a ``meta`` stand-in (the dry run's)."""
    return all(t.device.type == "meta" for t in tensors)


def _check_scan_chunk(symbol: str) -> None:
    """Raise unless the kernel's chunk of saved states is SCAN_CHUNK."""
    got = cuda_build.query(symbol)()
    if got != SCAN_CHUNK:
        raise RuntimeError(f"{symbol}() = {got}, but the wrapper lays the "
                           f"chunk states out by SCAN_CHUNK = {SCAN_CHUNK}")


def _scan_forward(x, dt, b, c, a, d_skip, h0, states: bool):
    """(y, h_last, chunk states [B, ceil(S / SCAN_CHUNK), Di, N] or None
    when not ``states``): the kernel on the card, the plain loop on the
    CPU, empty outputs on ``meta``; one counted launch on each."""
    bsz, s, d_in = (int(n) for n in x.shape)
    work = selective_scan_work(bsz, s, d_in, int(a.shape[1]), h0 is not None,
                               states)
    ins = (x, dt, b, c, a, d_skip) + (() if h0 is None else (h0,))
    with _count.kernel("selective_scan", work, ins):
        return _scan_forward_body(x, dt, b, c, a, d_skip, h0, states)


def _scan_forward_body(x, dt, b, c, a, d_skip, h0, states: bool):
    ins = (x, dt, b, c, a, d_skip) + (() if h0 is None else (h0,))
    if _on_meta(*ins):
        bsz, s, d_in = x.shape
        n = a.shape[1]
        return (torch.empty_like(x),
                x.new_empty((bsz, d_in, n)),
                x.new_empty((bsz, _scan_chunks(s), d_in, n))
                if states else None)
    if not _on_card(*ins):
        if states:
            return ref.selective_scan_fwd_ref(x, dt, b, c, a, d_skip, h0,
                                              SCAN_CHUNK)
        return (*ref.selective_scan_ref(x, dt, b, c, a, d_skip, h0), None)
    bsz, s, d_in = (int(n) for n in x.shape)
    n = int(a.shape[1])
    if n not in SCAN_STATES:
        raise ValueError(f"selective_scan: state width {n} is not one of "
                         f"{SCAN_STATES}")
    args = (x, dt, b, c, a, d_skip) + (() if h0 is None else (h0,))
    for t, (name, shape) in zip(args, _scan_shapes(x, a).items()):
        _check(t, name, torch.float32, shape)
    y = torch.empty_like(x)
    h_last = torch.empty((bsz, d_in, n), dtype=torch.float32,
                         device=x.device)
    hc = None
    if states:
        _check_scan_chunk("selective_scan_chunk")
        hc = torch.empty((bsz, _scan_chunks(s), d_in, n),
                         dtype=torch.float32, device=x.device)
    rc = cuda_build.entry("selective_scan")(
        x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(), a.data_ptr(),
        d_skip.data_ptr(), None if h0 is None else h0.data_ptr(),
        y.data_ptr(), h_last.data_ptr(), None if hc is None else hc.data_ptr(),
        bsz, s, d_in, n, _stream())
    _launched("selective_scan", rc)
    return y, h_last, hc


class _SelectiveScan(torch.autograd.Function):
    """``selective_scan`` under autograd: the forward saves the chunk
    states, the backward is :func:`selective_scan_bwd`."""

    @staticmethod
    def forward(ctx, x, dt, b, c, a, d_skip, h0):
        ctx.set_materialize_grads(False)
        y, h_last, hc = _scan_forward(x, dt, b, c, a, d_skip, h0, True)
        ctx.save_for_backward(x, dt, b, c, a, d_skip, hc)
        ctx.has_h0 = h0 is not None
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        x, dt, b, c, a, d_skip, hc = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if dh_last is not None:
            dh_last = dh_last.contiguous()
        *grads, dh0 = selective_scan_bwd(x, dt, b, c, a, d_skip, hc, dy,
                                         dh_last)
        return (*grads, dh0 if ctx.has_h0 else None)


def selective_scan(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
                   h0: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba-1 forward scan ``h_t = exp(-dt_t ⊙ A) h_{t-1} + (dt_t x_t) ⊗
    B_t``, ``y_t = C_t · h_t + D ⊙ x_t``: x/dt [B, S, Di], b/c [B, S, N],
    a [Di, N], d_skip [Di], h0 [B, Di, N] or None (zero), all float32 and
    contiguous -> (y [B, S, Di], h_last [B, Di, N]). CUDA tensors launch the
    kernel (N in :data:`SCAN_STATES`); CPU tensors run
    :func:`ref.selective_scan_ref`.

    While autograd records (grad enabled and an input requiring grad) it
    is differentiable: the forward also keeps the state at the start of
    every SCAN_CHUNK steps (the kernel writes them; on the CPU
    :func:`ref.selective_scan_fwd_ref`), and the backward is
    :func:`selective_scan_bwd` from them, the hand-written kernel on the
    card. A kernel that fails to build or launch raises; nothing falls
    back to the plain version."""
    args = (x, dt, b, c, a, d_skip) + (() if h0 is None else (h0,))
    for t in args:
        _dtype_code(t, {torch.float32: 0}, "selective_scan")
    if x.ndim != 3 or a.ndim != 2:
        raise ValueError(f"selective_scan: expected x [B, S, Di] and a "
                         f"[Di, N], got {tuple(x.shape)} and "
                         f"{tuple(a.shape)}")
    for t, (name, shape) in zip((x, dt, b, c, a, d_skip, h0),
                                _scan_shapes(x, a).items()):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"selective_scan: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _SelectiveScan.apply(x, dt, b, c, a, d_skip, h0)
    y, h_last, _ = _scan_forward(x, dt, b, c, a, d_skip, h0, False)
    return y, h_last


def selective_scan_bwd(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, a: torch.Tensor,
                       d_skip: torch.Tensor, hc: torch.Tensor,
                       dy: torch.Tensor, dh_last: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, ...]:
    """The gradients of :func:`selective_scan` from its inputs, its chunk
    states ``hc`` [B, ceil(S / SCAN_CHUNK), Di, N], ``dy`` [B, S, Di] and
    ``dh_last`` [B, Di, N] (None: zero), all float32 and contiguous ->
    (dx, ddt, db, dc, da, dd, dh0), shaped as x, dt, b, c, a, d_skip and
    h0. CUDA tensors launch ``csrc/selective_scan_bwd.cu``; CPU tensors
    run :func:`ref.selective_scan_bwd_ref`; ``meta`` tensors get empty
    gradients. One counted launch on each."""
    bsz, s, d_in = (int(n) for n in x.shape)
    ins = (x, dt, b, c, a, d_skip, hc, dy) + (
        () if dh_last is None else (dh_last,))
    with _count.kernel("selective_scan_bwd", selective_scan_bwd_work(
            bsz, s, d_in, int(a.shape[1])), ins):
        return _scan_bwd_body(x, dt, b, c, a, d_skip, hc, dy, dh_last)


def _scan_bwd_body(x, dt, b, c, a, d_skip, hc, dy, dh_last):
    extra = (hc, dy) + (() if dh_last is None else (dh_last,))
    if _on_meta(x, dt, b, c, a, d_skip, *extra):
        return (*(torch.empty_like(t) for t in (x, x, b, c, a, d_skip)),
                x.new_empty((x.shape[0], x.shape[2], a.shape[1])))
    if not _on_card(x, dt, b, c, a, d_skip, *extra):
        return ref.selective_scan_bwd_ref(x, dt, b, c, a, d_skip, hc, dy,
                                          dh_last, SCAN_CHUNK)
    bsz, s, d_in = (int(n) for n in x.shape)
    n = int(a.shape[1])
    if n not in SCAN_STATES:
        raise ValueError(f"selective_scan_bwd: state width {n} is not one "
                         f"of {SCAN_STATES}")
    shapes = _scan_shapes(x, a)
    for t, (name, shape) in zip((x, dt, b, c, a, d_skip), shapes.items()):
        _check(t, name, torch.float32, shape)
    _check(hc, "hc", torch.float32, (bsz, _scan_chunks(s), d_in, n))
    _check(dy, "dy", torch.float32, shapes["x"])
    if dh_last is not None:
        _check(dh_last, "dh_last", torch.float32, shapes["h0"])
    _check_scan_chunk("selective_scan_bwd_chunk")
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    db, dc = torch.zeros_like(b), torch.zeros_like(c)
    da, dd = torch.zeros_like(a), torch.zeros_like(d_skip)
    dh0 = torch.empty(shapes["h0"], dtype=torch.float32, device=x.device)
    rc = cuda_build.entry("selective_scan_bwd")(
        x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(), a.data_ptr(),
        d_skip.data_ptr(), hc.data_ptr(), dy.data_ptr(),
        None if dh_last is None else dh_last.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), db.data_ptr(), dc.data_ptr(), da.data_ptr(),
        dd.data_ptr(), dh0.data_ptr(), bsz, s, d_in, n, _stream())
    _launched("selective_scan_bwd", rc)
    return dx, ddt, db, dc, da, dd, dh0

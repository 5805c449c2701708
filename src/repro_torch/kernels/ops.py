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
    ``csrc/minplus_sweep.cu`` (a copy, then an atomic scatter-min of both
    directions of every edge, candidates read from the input). Replaces
    ``repro/kernels/minplus_sweep.py::minplus_sweep``.

``selective_scan``
    The Mamba-1 forward scan with an initial and a final state: every
    layer of LM prefill and of every decode step. CUDA C++ in
    ``csrc/selective_scan.cu`` (a thread per state element with h in a
    register, N lanes of a warp per channel, y by a shuffle reduction).
    Replaces ``repro/kernels/selective_scan.py::selective_scan``.

Dispatch: a wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors; a mix raises, and there is no fallback from one to
the other. Each launch adds one to :data:`LAUNCHES`. A dtype a kernel does
not take raises ``ValueError``.
"""
from __future__ import annotations

import torch

from .. import cuda_build
from ..cuda_build import check as _check
from ..cuda_build import on_card as _on_card
from ..cuda_build import stream as _stream
from . import ref

#: Kernel launches per wrapper since the last :func:`reset_launches`.
LAUNCHES = {"lane_cumsum": 0, "frontier_min": 0, "minplus_sweep": 0,
            "selective_scan": 0}

#: Vertex columns a frontier_min thread may own, widest first.
MIN_VEC_WIDTHS = (8, 4, 1)
_CUMSUM_DTYPES = {torch.int32: 0, torch.float32: 1}
_MIN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: State widths the scan kernel takes (the lanes of one channel divide a
#: warp).
SCAN_STATES = (4, 8, 16, 32)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def minplus_sweep(dist: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                  mask: torch.Tensor, cost: float = 1.0) -> torch.Tensor:
    """One undirected min-plus relaxation sweep, Jacobi: dist [V] float32,
    src/dst [E] int32 in [0, V), mask [E] bool -> [V]. Bit-identical to
    :func:`ref.minplus_relax`. CUDA tensors launch the kernel; CPU tensors
    run the plain version."""
    _dtype_code(dist, {torch.float32: 0}, "minplus_sweep")
    if not _on_card(dist, src, dst, mask):
        return ref.minplus_relax(dist, src, dst, mask, cost)
    v, e = int(dist.numel()), int(src.numel())
    _check(dist, "dist", torch.float32, (v,))
    _check(src, "src", torch.int32, (e,))
    _check(dst, "dst", torch.int32, (e,))
    _check(mask, "mask", torch.bool, (e,))
    out = torch.empty_like(dist)
    rc = cuda_build.entry("minplus_sweep")(
        dist.data_ptr(), src.data_ptr(), dst.data_ptr(), mask.data_ptr(),
        out.data_ptr(), v, e, float(cost), _stream())
    _launched("minplus_sweep", rc)
    return out


def selective_scan(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
                   h0: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba-1 forward scan ``h_t = exp(-dt_t ⊙ A) h_{t-1} + (dt_t x_t) ⊗
    B_t``, ``y_t = C_t · h_t + D ⊙ x_t``: x/dt [B, S, Di], b/c [B, S, N],
    a [Di, N], d_skip [Di], h0 [B, Di, N] or None (zero), all float32 and
    contiguous -> (y [B, S, Di], h_last [B, Di, N]). CUDA tensors launch the
    kernel (N in :data:`SCAN_STATES`); CPU tensors run
    :func:`ref.selective_scan_ref`."""
    args = (x, dt, b, c, a, d_skip) + (() if h0 is None else (h0,))
    for t in args:
        _dtype_code(t, {torch.float32: 0}, "selective_scan")
    if x.ndim != 3 or a.ndim != 2:
        raise ValueError(f"selective_scan: expected x [B, S, Di] and a "
                         f"[Di, N], got {tuple(x.shape)} and "
                         f"{tuple(a.shape)}")
    bsz, s, d_in = (int(n) for n in x.shape)
    n = int(a.shape[1])
    shapes = {"x": (bsz, s, d_in), "dt": (bsz, s, d_in), "b": (bsz, s, n),
              "c": (bsz, s, n), "a": (d_in, n), "d_skip": (d_in,),
              "h0": (bsz, d_in, n)}
    for t, (name, shape) in zip((x, dt, b, c, a, d_skip, h0),
                                shapes.items()):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"selective_scan: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    if not _on_card(*args):
        return ref.selective_scan_ref(x, dt, b, c, a, d_skip, h0)
    if n not in SCAN_STATES:
        raise ValueError(f"selective_scan: state width {n} is not one of "
                         f"{SCAN_STATES}")
    for t, (name, shape) in zip(args, shapes.items()):
        _check(t, name, torch.float32, shape)
    y = torch.empty_like(x)
    h_last = torch.empty((bsz, d_in, n), dtype=torch.float32,
                         device=x.device)
    rc = cuda_build.entry("selective_scan")(
        x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(), a.data_ptr(),
        d_skip.data_ptr(), None if h0 is None else h0.data_ptr(),
        y.data_ptr(), h_last.data_ptr(), bsz, s, d_in, n, _stream())
    _launched("selective_scan", rc)
    return y, h_last

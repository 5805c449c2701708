"""Chunked edge-update ingestion into the static-shape ``Graph``.

Counterpart of ``repro.stream.ingest``. ``StreamingGraph`` is the mutable
host-side front of the streaming subsystem: it mirrors the Graph's flat
slot arrays in numpy, keeps an exact (u, v) -> slot index, and applies
updates in fixed-size chunks:

  * insertions claim spare (masked) padded slots — the padding every Graph
    already carries becomes ingest headroom, and plans compiled against
    the padded shape stay shape-stable;
  * deletions clear ``edge_mask`` and return the slot to the free list;
  * when a chunk of insertions cannot fit in the remaining spare slots the
    graph is *compacted*: real edges are repacked into a prefix (keeping
    their relative slot order so parallel per-slot state like the owner
    array remaps with one gather) and re-padded with fresh headroom. Each
    compaction bumps ``epoch``; downstream, a compaction is the only event
    that recompiles plans.

Updates are canonicalised exactly like ``graph.from_edge_array``: u < v,
self-loops dropped, duplicates (against the live edge set and within the
chunk) ignored. The slot bookkeeping is host numpy, as in the reference;
:meth:`StreamingGraph.graph` hands the Graph over on the device of the
graph the stream started from.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.graph import Graph, apply_edge_updates


def _align(x: int, to: int = 128) -> int:
    return max(to, -(-x // to) * to)


@dataclasses.dataclass
class ApplyResult:
    """Slots touched by one chunk application (parallel arrays)."""
    slots: np.ndarray   # [M] int64 slot indices
    u: np.ndarray       # [M] int32 canonical endpoints (u < v)
    v: np.ndarray       # [M] int32


class StreamingGraph:
    """Mutable slot-level view over a static-shape Graph."""

    def __init__(self, g: Graph, chunk_size: int = 256):
        if chunk_size <= 0:
            raise ValueError("chunk_size must be > 0")
        self.n_vertices = g.n_vertices
        self.chunk_size = int(chunk_size)
        self.device = g.device
        self.epoch = 0
        self._u = g.src.cpu().numpy().copy()
        self._v = g.dst.cpu().numpy().copy()
        self._mask = g.edge_mask.cpu().numpy().copy()
        self._rebuild_index()
        self._graph_cache: Graph | None = g
        self._dirty: set[int] = set()

    # -- bookkeeping --------------------------------------------------------
    def _rebuild_index(self) -> None:
        live = np.flatnonzero(self._mask)
        keys = (self._u[live].astype(np.int64) * self.n_vertices
                + self._v[live])
        self._index = dict(zip(keys.tolist(), live.tolist()))
        self._free = np.flatnonzero(~self._mask).tolist()[::-1]  # stack

    @property
    def n_edges(self) -> int:
        return len(self._index)

    @property
    def e_pad(self) -> int:
        return len(self._u)

    def free_slots(self) -> int:
        return len(self._free)

    def slot_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The host mirrors (src, dst, edge_mask) of every slot, as the
        next :meth:`graph` holds them (read them, do not write)."""
        return self._u, self._v, self._mask

    def live_edges(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(u, v) of the live edges and the live-slot mask, host arrays
        (``graph().as_numpy()`` without reading the device)."""
        m = self._mask.copy()
        return self._u[m], self._v[m], m

    def _canon(self, edges) -> tuple[np.ndarray, np.ndarray]:
        edges = np.asarray(edges, np.int64).reshape(-1, 2)
        if edges.size and (edges.min() < 0
                           or edges.max() >= self.n_vertices):
            raise ValueError("streamed endpoints must be existing vertex ids "
                             "(|V| is static)")
        u = np.minimum(edges[:, 0], edges[:, 1])
        v = np.maximum(edges[:, 0], edges[:, 1])
        keep = u != v
        return u[keep].astype(np.int32), v[keep].astype(np.int32)

    def _check_chunk(self, u: np.ndarray) -> None:
        if len(u) > self.chunk_size:
            raise ValueError("chunk exceeds the fixed chunk size")

    # -- chunk application --------------------------------------------------
    def insert_chunk(self, edges) -> ApplyResult:
        """Insert up to ``chunk_size`` canonicalised edges into spare slots.
        Already-present edges are skipped. Raises if slots run out — callers
        check ``free_slots()`` and compact first."""
        u, v = self._canon(edges)
        self._check_chunk(u)
        slots, au, av = [], [], []
        for a, b in zip(u.tolist(), v.tolist()):
            key = a * self.n_vertices + b
            if key in self._index:
                continue
            if not self._free:
                raise RuntimeError("no spare edge slots; compact() first")
            s = self._free.pop()
            self._u[s], self._v[s], self._mask[s] = a, b, True
            self._index[key] = s
            slots.append(s), au.append(a), av.append(b)
        self._dirty.update(slots)
        return ApplyResult(np.asarray(slots, np.int64),
                           np.asarray(au, np.int32), np.asarray(av, np.int32))

    def delete_chunk(self, edges) -> ApplyResult:
        """Delete up to ``chunk_size`` edges (unknown edges are skipped)."""
        u, v = self._canon(edges)
        self._check_chunk(u)
        slots, au, av = [], [], []
        for a, b in zip(u.tolist(), v.tolist()):
            s = self._index.pop(a * self.n_vertices + b, None)
            if s is None:
                continue
            self._mask[s] = False
            self._free.append(s)
            slots.append(s), au.append(a), av.append(b)
        self._dirty.update(slots)
        return ApplyResult(np.asarray(slots, np.int64),
                           np.asarray(au, np.int32), np.asarray(av, np.int32))

    # -- compaction epoch ---------------------------------------------------
    def compact(self, headroom_frac: float = 0.5) -> np.ndarray:
        """Repack live edges into a prefix (relative order preserved) and
        re-pad with ``headroom_frac * |E|`` fresh spare slots. Bumps
        ``epoch``. Returns the old slot index of each new prefix slot so
        per-slot companion state (the owner array) remaps with one gather."""
        live = np.flatnonzero(self._mask)
        e = len(live)
        pad = _align(e + max(self.chunk_size, int(headroom_frac * e)))
        nu = np.zeros(pad, np.int32)
        nv = np.zeros(pad, np.int32)
        nm = np.zeros(pad, bool)
        nu[:e], nv[:e], nm[:e] = self._u[live], self._v[live], True
        self._u, self._v, self._mask = nu, nv, nm
        self._rebuild_index()
        self._graph_cache = None      # shape changed: full rebuild
        self._dirty.clear()
        self.epoch += 1
        return live

    # -- materialisation ----------------------------------------------------
    def graph(self) -> Graph:
        """Static-shape Graph over the current slot arrays, on the stream's
        device. Incremental: only the slots dirtied since the last
        materialisation are rewritten (``core.graph.apply_edge_updates``);
        a compaction forces a full rebuild."""
        if self._graph_cache is None:
            def t(a):
                return torch.from_numpy(a.copy()).to(self.device)
            self._graph_cache = Graph(self.n_vertices, self.n_edges,
                                      t(self._u), t(self._v), t(self._mask))
        elif self._dirty:
            s = np.fromiter(self._dirty, np.int64, len(self._dirty))
            self._graph_cache = apply_edge_updates(
                self._graph_cache, s, self._u[s], self._v[s], self._mask[s])
            self._dirty.clear()
        return self._graph_cache


def iter_chunks(edges, chunk_size: int):
    """Split an [M, 2] update list into fixed-size chunks (last one ragged)."""
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    for i in range(0, len(edges), chunk_size):
        yield edges[i:i + chunk_size]

"""The cells' graphs, generated again by the benchmark from the seed.

A frozen copy of the generator path that ``src/repro_torch/core/graph.py``
runs for a configuration's ``graph``: ``barabasi_albert``, the dedupe and
padding of ``from_edge_array`` and ``largest_component``, all host-side
NumPy. Given the same parameters and seed it draws the same edges in the
same slots. The reference answers queries and partitions on this edge
list, never on the program's graph; the check holds the program's graph
equal to it slot for slot, so that a fault in the program's generator,
component cut or padding reads as not correct.
"""
from __future__ import annotations

import numpy as np

from . import EdgeList


def barabasi_albert(n: int, m: int, seed: int) -> np.ndarray:
    """[E, 2] edges of the preferential-attachment draw."""
    rng = np.random.default_rng(seed)
    targets = list(range(m))
    repeated: list[int] = []
    edges = []
    for v in range(m, n):
        for t in targets:
            edges.append((v, t))
        repeated.extend(targets)
        repeated.extend([v] * m)
        idx = rng.integers(0, len(repeated), size=3 * m)
        cand = {repeated[i] for i in idx}
        targets = list(cand)[:m]
        while len(targets) < m:
            t = int(rng.integers(0, v + 1))
            if t not in targets:
                targets.append(t)
    return np.array(edges)


def edge_list(n: int, edges: np.ndarray) -> EdgeList:
    """Undirected edges, deduped, self loops dropped, sorted by (u, v) with
    u < v, padded with masked slots to a multiple of 128."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    u = np.minimum(edges[:, 0], edges[:, 1])
    v = np.maximum(edges[:, 0], edges[:, 1])
    keep = u != v
    uniq = np.unique(u[keep] * n + v[keep])
    e = len(uniq)
    pad = max(128, -(-e // 128) * 128)
    src = np.zeros(pad, np.int32)
    dst = np.zeros(pad, np.int32)
    mask = np.zeros(pad, bool)
    src[:e], dst[:e], mask[:e] = uniq // n, uniq % n, True
    return EdgeList(int(n), src, dst, mask)


def largest_component(g: EdgeList) -> EdgeList:
    """The largest connected component, its vertices renumbered in order."""
    u, v = g.src[g.mask].astype(np.int64), g.dst[g.mask].astype(np.int64)
    n = g.n_vertices
    label = np.arange(n)
    for _ in range(n):
        m = np.minimum(label[u], label[v])
        new = label.copy()
        np.minimum.at(new, u, m)
        np.minimum.at(new, v, m)
        if np.array_equal(new, label):
            break
        label = new
    roots, counts = np.unique(label, return_counts=True)
    big = roots[np.argmax(counts)]
    keep = (label[u] == big) & (label[v] == big)
    u, v = u[keep], v[keep]
    verts = np.unique(np.concatenate([u, v]))
    remap = np.full(n, -1, np.int64)
    remap[verts] = np.arange(len(verts))
    return edge_list(len(verts), np.stack([remap[u], remap[v]], 1))


def make(graph: dict, scale: float, seed: int) -> EdgeList:
    """The largest component of the graph a configuration's ``graph``
    entry describes, at ``scale`` of its vertices, drawn from ``seed``."""
    if graph["model"] != "barabasi_albert":
        raise ValueError(f"no frozen generator for {graph['model']!r}")
    n = int(graph["vertices"] * scale)
    return largest_component(
        edge_list(n, barabasi_albert(n, graph["m"], int(seed) % 2**63)))


def slot_mismatch(want: EdgeList, n_vertices: int, src, dst, mask) -> int:
    """Slots where the program's graph differs from ``want``: every slot
    when the vertex count or the padded length differs."""
    src, dst, mask = (np.asarray(a) for a in (src, dst, mask))
    if n_vertices != want.n_vertices or len(src) != len(want.src):
        return max(len(src), len(want.src))
    live = want.mask | mask
    differ = ((src != want.src) | (dst != want.dst)) & live
    return int((differ | (mask != want.mask)).sum())

"""Static-shape undirected graph container + synthetic generators (PyTorch).

Counterpart of ``repro.core.graph``. The graph is kept in flat, fixed-shape
tensors on one device:

  * ``src``/``dst``  — one row per *undirected* edge (padded slots hold 0/0
    and are masked out by ``edge_mask``),
  * degrees / CSR derived where needed.

Generators are host-side numpy and deterministic given a seed: for the same
arguments they build the same edge arrays as the reference, so the two
packages partition and query the same graph. ``DATASETS`` holds the paper's
dataset profiles (synthetic stand-ins matching the published |V|, |E|,
diameter class and clustering class).

Entry points that place tensors take ``device``; ``None`` means ``"cuda"``,
and a missing card raises instead of falling back to the CPU.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``. A CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the GPU by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


@dataclasses.dataclass(frozen=True)
class Graph:
    """Undirected graph, one row per undirected edge, padded to a static size."""

    n_vertices: int          # number of vertices
    n_edges: int             # number of REAL edges (<= padded size)
    src: torch.Tensor        # [E_pad] int32
    dst: torch.Tensor        # [E_pad] int32
    edge_mask: torch.Tensor  # [E_pad] bool — True for real edges

    @property
    def e_pad(self) -> int:
        return int(self.src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.src.device

    def to(self, device) -> "Graph":
        return Graph(self.n_vertices, self.n_edges, self.src.to(device),
                     self.dst.to(device), self.edge_mask.to(device))

    def degrees(self) -> torch.Tensor:
        """Vertex degrees, [V] int32 (each undirected edge counts once per side)."""
        m = self.edge_mask.to(torch.int32)
        d = torch.zeros(self.n_vertices, dtype=torch.int32, device=self.device)
        d.index_add_(0, self.src, m)
        d.index_add_(0, self.dst, m)
        return d

    def as_numpy(self) -> tuple[np.ndarray, np.ndarray]:
        m = self.edge_mask.cpu().numpy()
        return self.src.cpu().numpy()[m], self.dst.cpu().numpy()[m]

    def fingerprint(self) -> str:
        """Stable content hash over the *masked* edge set — the same sha256
        as the reference's ``Graph.fingerprint`` for the same edge set."""
        u, v = self.as_numpy()
        keys = np.sort(u.astype(np.int64) * self.n_vertices + v)
        h = hashlib.sha256()
        h.update(np.int64(self.n_vertices).tobytes())
        h.update(keys.tobytes())
        return h.hexdigest()


#: Modulus of the deterministic edge-weight hash (prime, so the low bits of
#: the endpoint mix spread evenly over [1, 2)).
EDGE_WEIGHT_MOD = 1_000_003


def edge_weights(u, v) -> np.ndarray:
    """Deterministic per-edge float32 weights in [1, 2): a pure content hash
    of the (undirected) endpoint pair, bit-equal to the reference's."""
    a = np.minimum(u, v).astype(np.int64)
    b = np.maximum(u, v).astype(np.int64)
    h = (a * 2654435761 + b * 97_571 + 12_345) % EDGE_WEIGHT_MOD
    return (1.0 + h / EDGE_WEIGHT_MOD).astype(np.float32)


def apply_edge_updates(g: Graph, slots, new_src, new_dst,
                       new_mask) -> Graph:
    """Functional slot-level mutation: write (src, dst, mask) at ``slots``
    on the graph's device and return a new Graph; ``g`` is untouched.

    ``StreamingGraph.graph()`` (``repro_torch.stream.ingest``) materialises
    mutated graphs through this: insertions claim masked (spare) slots,
    deletions clear ``edge_mask``. Shapes never change.
    """
    dev = g.device
    idx = torch.as_tensor(np.asarray(slots, np.int64), device=dev)

    def put(field, vals, dtype):
        out = field.clone()
        out[idx] = torch.as_tensor(np.asarray(vals), device=dev).to(dtype)
        return out

    src = put(g.src, new_src, torch.int32)
    dst = put(g.dst, new_dst, torch.int32)
    mask = put(g.edge_mask, new_mask, torch.bool)
    return Graph(g.n_vertices, int(mask.sum()), src, dst, mask)


def from_edge_array(n_vertices: int, edges: np.ndarray,
                    pad_to: int | None = None, device=None) -> Graph:
    """Build a Graph from an [E, 2] int array of undirected edges.

    Dedupes (u,v)/(v,u), drops self loops, pads to ``pad_to`` (default: next
    multiple of 128, the reference's padding).
    """
    dev = resolve_device(device)
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    u = np.minimum(edges[:, 0], edges[:, 1])
    v = np.maximum(edges[:, 0], edges[:, 1])
    keep = u != v
    u, v = u[keep], v[keep]
    uniq = np.unique(u * n_vertices + v)
    u, v = (uniq // n_vertices).astype(np.int32), (uniq % n_vertices).astype(np.int32)
    e = len(u)
    if pad_to is None:
        pad_to = max(128, -(-e // 128) * 128)
    if pad_to < e:
        raise ValueError(f"pad_to={pad_to} is smaller than the {e} edges")
    pu = np.zeros(pad_to, np.int32)
    pv = np.zeros(pad_to, np.int32)
    pm = np.zeros(pad_to, bool)
    pu[:e], pv[:e], pm[:e] = u, v, True
    return Graph(int(n_vertices), int(e), torch.from_numpy(pu).to(dev),
                 torch.from_numpy(pv).to(dev), torch.from_numpy(pm).to(dev))


def graph_from_numpy(ref, device=None) -> Graph:
    """Port a graph from any object with ``n_vertices``, ``n_edges``, ``src``,
    ``dst`` and ``edge_mask`` attributes (arrays convertible by
    ``np.asarray``, e.g. a reference ``repro.core.graph.Graph``)."""
    dev = resolve_device(device)

    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)

    return Graph(int(ref.n_vertices), int(ref.n_edges), t(ref.src, np.int32),
                 t(ref.dst, np.int32), t(ref.edge_mask, bool))


# ---------------------------------------------------------------------------
# Generators (host-side numpy; deterministic by seed, same edges as the
# reference's generators)
# ---------------------------------------------------------------------------

def barabasi_albert(n: int, m: int, seed: int = 0, device=None) -> Graph:
    """Preferential-attachment graph: small diameter, power-law degrees.

    Matches the ASTROPH / EMAIL-ENRON / DBLP dataset class of the paper.
    """
    rng = np.random.default_rng(seed)
    targets = list(range(m))
    repeated: list[int] = []
    edges = []
    for v in range(m, n):
        for t in targets:
            edges.append((v, t))
        repeated.extend(targets)
        repeated.extend([v] * m)
        # sample next targets from the degree-weighted multiset
        idx = rng.integers(0, len(repeated), size=3 * m)
        cand = {repeated[i] for i in idx}
        targets = list(cand)[:m]
        while len(targets) < m:
            t = int(rng.integers(0, v + 1))
            if t not in targets:
                targets.append(t)
    return from_edge_array(n, np.array(edges), device=device)


def watts_strogatz(n: int, k: int, beta: float, seed: int = 0,
                   device=None) -> Graph:
    """Ring lattice with rewiring: high clustering coefficient (WORDNET class)."""
    rng = np.random.default_rng(seed)
    u = np.repeat(np.arange(n), k // 2)
    off = np.tile(np.arange(1, k // 2 + 1), n)
    v = (u + off) % n
    rewire = rng.random(len(u)) < beta
    v = np.where(rewire, rng.integers(0, n, size=len(u)), v)
    return from_edge_array(n, np.stack([u, v], 1), device=device)


def road_network(rows: int, cols: int, extra_frac: float = 0.25,
                 seed: int = 0, device=None) -> Graph:
    """USROADS class: near-tree planar grid — huge diameter, degree ≈ 2.6.

    Random spanning tree of the rows×cols grid + ``extra_frac·V`` extra grid
    edges. Diameter is O(rows+cols) like a road network.
    """
    rng = np.random.default_rng(seed)
    n = rows * cols

    def vid(r, c):
        return r * cols + c

    es = []
    for r in range(rows):
        for c in range(cols):
            if c + 1 < cols:
                es.append((vid(r, c), vid(r, c + 1)))
            if r + 1 < rows:
                es.append((vid(r, c), vid(r + 1, c)))
    es = np.array(es)
    perm = rng.permutation(len(es))
    es = es[perm]
    # Kruskal spanning tree (union-find)
    parent = np.arange(n)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    tree, extra = [], []
    for a, b in es:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb
            tree.append((a, b))
        else:
            extra.append((a, b))
    n_extra = int(extra_frac * n)
    keep = extra[:n_extra]
    return from_edge_array(n, np.array(tree + keep), device=device)


def erdos_renyi(n: int, e: int, seed: int = 0, device=None) -> Graph:
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n, size=int(e * 1.3))
    v = rng.integers(0, n, size=int(e * 1.3))
    g = from_edge_array(n, np.stack([u, v], 1), device=device)
    if g.n_edges > e:  # trim to target
        su, sv = g.as_numpy()
        return from_edge_array(n, np.stack([su[:e], sv[:e]], 1), device=device)
    return g


def remap_edges(g: Graph, fraction: float, seed: int = 0) -> Graph:
    """Paper Fig-6 protocol: remap a random fraction of edges to random
    endpoints, lowering the diameter while keeping |V|, |E| fixed."""
    rng = np.random.default_rng(seed)
    u, v = g.as_numpy()
    n = g.n_vertices
    k = int(fraction * len(u))
    idx = rng.choice(len(u), size=k, replace=False)
    side = rng.random(k) < 0.5
    new_end = rng.integers(0, n, size=k)
    u2, v2 = u.copy(), v.copy()
    u2[idx] = np.where(side, new_end, u2[idx])
    v2[idx] = np.where(~side, new_end, v2[idx])
    return from_edge_array(n, np.stack([u2, v2], 1), pad_to=g.e_pad,
                           device=g.device)


def largest_component(g: Graph) -> Graph:
    """Restrict to the largest connected component (paper cleans SNAP data
    the same way). The result stays on ``g``'s device."""
    u, v = g.as_numpy()
    n = g.n_vertices
    label = np.arange(n)
    # label propagation until fixpoint (numpy; bounded by diameter)
    for _ in range(n):
        lu, lv = label[u], label[v]
        m = np.minimum(lu, lv)
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
    # compact vertex ids
    verts = np.unique(np.concatenate([u, v]))
    remap = np.full(n, -1, np.int64)
    remap[verts] = np.arange(len(verts))
    return from_edge_array(len(verts), np.stack([remap[u], remap[v]], 1),
                           device=g.device)


# ---------------------------------------------------------------------------
# Paper dataset profiles (synthetic stand-ins; scale=1.0 matches published |V|)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    builder: Callable[[float, int, torch.device], Graph]
    table: str        # "II" (simulation) or "III" (EC2)
    v_published: int
    e_published: int
    diameter_published: int


# The builders generate on the CPU and move only the final graph to the
# device: largest_component reads the edges back to the host anyway.
def _astroph(scale: float, seed: int, device) -> Graph:
    return largest_component(
        barabasi_albert(int(17903 * scale), 11, seed, device="cpu")).to(device)


def _email_enron(scale: float, seed: int, device) -> Graph:
    return largest_component(
        barabasi_albert(int(33696 * scale), 5, seed, device="cpu")).to(device)


def _usroads(scale: float, seed: int, device) -> Graph:
    side = int(np.sqrt(126146 * scale))
    return largest_component(
        road_network(side, side, 0.28, seed, device="cpu")).to(device)


def _wordnet(scale: float, seed: int, device) -> Graph:
    return largest_component(
        watts_strogatz(int(75606 * scale), 6, 0.1, seed, device="cpu")
    ).to(device)


def _dblp(scale: float, seed: int, device) -> Graph:
    return largest_component(
        barabasi_albert(int(317080 * scale), 3, seed, device="cpu")).to(device)


def _youtube(scale: float, seed: int, device) -> Graph:
    return largest_component(
        barabasi_albert(int(1134890 * scale), 3, seed, device="cpu")
    ).to(device)


def _amazon(scale: float, seed: int, device) -> Graph:
    return largest_component(
        barabasi_albert(int(400727 * scale), 6, seed, device="cpu")).to(device)


DATASETS: dict[str, DatasetSpec] = {
    "astroph":     DatasetSpec("astroph", _astroph, "II", 17903, 196972, 14),
    "email-enron": DatasetSpec("email-enron", _email_enron, "II", 33696, 180811, 13),
    "usroads":     DatasetSpec("usroads", _usroads, "II", 126146, 161950, 617),
    "wordnet":     DatasetSpec("wordnet", _wordnet, "II", 75606, 231622, 14),
    "dblp":        DatasetSpec("dblp", _dblp, "III", 317080, 1049866, 21),
    "youtube":     DatasetSpec("youtube", _youtube, "III", 1134890, 2987624, 20),
    "amazon":      DatasetSpec("amazon", _amazon, "III", 400727, 2349869, 18),
}


def load_dataset(name: str, scale: float = 1.0, seed: int = 0,
                 device=None) -> Graph:
    dev = resolve_device(device)   # raise before minutes of generation
    return DATASETS[name].builder(scale, seed, dev)

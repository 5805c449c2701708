"""The plain references: the path programs against brute force on tiny
hand-made graphs, the frozen DFEP and byte counts against the port's (in
the test only: the benchmark never calls the port to judge it)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import bounds
from perfbench.reference import EdgeList, bfs, dfep, graphgen, sssp, wsssp
from perfbench.reference.weights import edge_weights
from perfbench.tests import tiny

INF = np.float32(np.inf)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with tiny.one_thread():
        yield


def _graph(n, edges, pad=3):
    e = np.array(edges, np.int64).reshape(-1, 2)
    src = np.concatenate([e[:, 0], np.zeros(pad, np.int64)])
    dst = np.concatenate([e[:, 1], np.zeros(pad, np.int64)])
    mask = np.concatenate([np.ones(len(e), bool), np.zeros(pad, bool)])
    return EdgeList(n, src, dst, mask)


GRAPHS = {
    "path": _graph(5, [(0, 1), (1, 2), (2, 3), (3, 4)]),
    "cycle": _graph(6, [(i, (i + 1) % 6) for i in range(6)]),
    "star_and_chord": _graph(6, [(0, i) for i in range(1, 6)] + [(2, 3)]),
    "grid": _graph(9, [(r * 3 + c, r * 3 + c + 1) for r in range(3)
                       for c in range(2)]
                   + [(r * 3 + c, (r + 1) * 3 + c) for r in range(2)
                      for c in range(3)]),
    "two_parts": _graph(7, [(0, 1), (1, 2), (2, 0), (3, 4), (4, 5)]),
}


def _brute(g: EdgeList, source: int, weighted: bool) -> np.ndarray:
    """Least float32 path sum over every simple path from ``source``,
    each summed from the source, by enumeration."""
    m = g.mask
    u, v = g.src[m], g.dst[m]
    w = edge_weights(u, v) if weighted else np.ones(len(u), np.float32)
    adj = {i: [] for i in range(g.n_vertices)}
    for a, b, x in zip(u, v, w):
        adj[int(a)].append((int(b), x))
        adj[int(b)].append((int(a), x))
    best = np.full(g.n_vertices, INF, np.float32)

    def walk(x, d, seen):
        best[x] = min(best[x], d)
        for y, c in adj[x]:
            if y not in seen:
                walk(y, np.float32(d + c), seen | {y})

    walk(source, np.float32(0), {source})
    return best


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_path_references_equal_brute_force(name):
    g = GRAPHS[name]
    srcs = np.arange(g.n_vertices)
    got = {p.__name__.split(".")[-1]: p.solve(g, srcs).numpy()
           for p in (sssp, bfs, wsssp)}
    for s in srcs:
        hops = _brute(g, int(s), False)
        assert np.array_equal(got["sssp"][s], hops)
        assert np.array_equal(got["bfs"][s], np.where(hops == INF, -1, hops))
        assert np.array_equal(got["wsssp"][s], _brute(g, int(s), True))


def test_bfloat16_weighted_paths_differ():
    g = GRAPHS["grid"]
    lo = wsssp.solve(g, [0, 4], dtype=torch.bfloat16).numpy()
    assert not np.array_equal(lo, wsssp.solve(g, [0, 4]).numpy())


@pytest.mark.parametrize("name,scale,seed,k", [("dblp", 0.0005, 1, 4),
                                               ("usroads", 0.004, 2, 16)])
def test_frozen_dfep_equals_the_port(name, scale, seed, k):
    from repro_torch.core import dfep as port, graph
    g = graph.load_dataset(name, scale=scale, seed=seed, device="cpu")
    el = EdgeList(g.n_vertices, g.src.numpy(), g.dst.numpy(),
                  g.edge_mask.numpy())
    starts = np.random.default_rng(seed).choice(g.n_vertices, k,
                                                 replace=False)
    owner, info = port.partition(g, k, starts=starts, device="cpu",
                                 max_rounds=4000, stall_rounds=64)
    want, rounds = dfep.partition(el, k, starts, max_rounds=4000,
                                  stall_rounds=64)
    assert rounds == info["rounds"]
    assert np.array_equal(owner.numpy(), want)


@pytest.mark.parametrize("seed", [3, 2**31 + 5, 2**63 + 9])
def test_frozen_generator_draws_the_ports_graph(seed):
    from repro_torch.core import graph
    cfg = {"model": "barabasi_albert", "vertices": 317080, "m": 3}
    g = graph.load_dataset("dblp", scale=0.002, seed=seed % 2**63,
                           device="cpu")
    want = graphgen.make(cfg, 0.002, seed)
    got = (g.n_vertices, g.src.numpy(), g.dst.numpy(), g.edge_mask.numpy())
    assert graphgen.slot_mismatch(want, *got) == 0
    assert want.n_edges == g.n_edges


def test_slot_mismatch_counts_each_differing_slot():
    g = GRAPHS["cycle"]
    src = g.src.copy()
    src[1] = 5
    assert graphgen.slot_mismatch(g, 6, src, g.dst, g.mask) == 1
    mask = g.mask.copy()
    mask[-1] = True
    assert graphgen.slot_mismatch(g, 6, g.src, g.dst, mask) == 1
    assert graphgen.slot_mismatch(g, 7, g.src, g.dst, g.mask) == len(g.src)
    assert graphgen.slot_mismatch(g, 6, g.src[:-1], g.dst[:-1],
                                  g.mask[:-1]) == len(g.src)


def test_frozen_byte_counts_equal_the_ports():
    from repro_torch import engine as E
    from repro_torch.core import dfep as port, graph
    from repro_torch.engine import kernels
    g = graph.load_dataset("dblp", scale=0.0005, seed=4, device="cpu")
    owner, _ = port.partition(g, 4, seed=4, device="cpu", max_rounds=50)
    plan = E.compile_plan(g, owner, 4, device="cpu")
    c = bounds.plan_counts(plan)
    for f in (1, 8, 32):
        assert bounds.segment_reduce_work(c, f) == \
            kernels.segment_reduce_work(plan, f)
        assert bounds.exchange_work(c, f) == kernels.exchange_work(plan, f)
    assert bounds.lane_cumsum_work(1000, 16) == (16_000, 128_000)
    assert bounds.least_seconds((0, 3.35e12)) == pytest.approx(1.0)


def test_cumsum_rows_is_exact():
    x = torch.randint(0, 2, (1000, 5), dtype=torch.int32)
    assert torch.equal(dfep.cumsum_rows(x), torch.cumsum(x, 0,
                                                         dtype=torch.int32))


def test_dfep_rejects_starts_that_are_not_k_distinct():
    g = GRAPHS["path"]
    with pytest.raises(ValueError):
        dfep.partition(g, 2, [1, 1])

"""repro_torch.core.etsch and .algorithms against repro.core.etsch and
.algorithms: the same partitionings give the same per-partition tensors,
and the ETSCH problems the same states and counters.

Held to: SSSP, CC (given the reference's ids), multi-source SSSP, MIS
(given the reference's priorities) and k-core bit-identical with equal
``supersteps`` (and ``local_iters`` where the reference counts them), since
min/max and integer sums have one answer; PageRank within rtol 1e-5
element by element, as the reference's own test holds it (float32 partial
sums in another order). The vertex-centric references equal in values and
round counts; the host numpy oracles equal (min programs) or within 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import algorithms as RA
from repro.core import baselines as RB
from repro.core import dfep as RD
from repro.core import etsch as RE
from repro.core import graph as RG
from repro_torch.core import algorithms as TA
from repro_torch.core import etsch as TE
from repro_torch.core import graph as TG

CPU = "cpu"
FIELDS = ("src", "dst", "mask", "member", "frontier")


@pytest.fixture(scope="module", params=["dfep", "random", "hash"])
def setup(request):
    """The reference's ETSCH fixture (tests/test_etsch.py): BA(500, 3),
    K=5, partitioned three ways; both packages' partitionings."""
    g = RG.barabasi_albert(500, 3, seed=2)
    k = 5
    if request.param == "dfep":
        owner, _ = RD.partition(g, k=k, key=0)
    elif request.param == "random":
        owner = RB.random_partition(g, k, seed=0)
    else:
        owner = RB.hash_partition(g, k)
    gt = TG.graph_from_numpy(g, device=CPU)
    part = RE.compile_partitioning(g, owner, k)
    pt = TE.compile_partitioning(gt, np.asarray(owner), k, device=CPU)
    return g, gt, part, pt


def _assert_same_partitioning(part, pt):
    assert (pt.k, pt.n_vertices, pt.e_max) == (part.k, part.n_vertices,
                                                part.e_max)
    for name in FIELDS:
        got, want = getattr(pt, name), np.asarray(getattr(part, name))
        assert got.dtype == (torch.int32 if want.dtype == np.int32
                             else torch.bool), name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    np.testing.assert_array_equal(pt.sizes.numpy(), np.asarray(part.sizes))


def test_compile_partitioning_and_from_reference(setup):
    _, _, part, pt = setup
    _assert_same_partitioning(part, pt)
    _assert_same_partitioning(part, TE.Partitioning.from_reference(
        part, device=CPU))
    base = np.arange(pt.k)[:, None] * pt.n_vertices
    np.testing.assert_array_equal(
        pt.flat_src.numpy(), (base + np.asarray(part.src)).reshape(-1))
    assert pt.flat_src.dtype == torch.int32
    assert pt.flat_dst is pt.flat_dst           # derived once per instance


def _assert_same_result(res, ref):
    np.testing.assert_array_equal(res.state.numpy(), np.asarray(ref.state))
    assert res.supersteps == int(ref.supersteps)
    assert res.local_iters == int(ref.local_iters)


def test_etsch_sssp_bit_identical(setup):
    g, gt, part, pt = setup
    for source in (0, 123):
        _assert_same_result(TA.etsch_sssp(pt, source),
                            RA.etsch_sssp(part, source))


def test_etsch_cc_bit_identical(setup):
    _, _, part, pt = setup
    ids = np.asarray(jax.random.permutation(jax.random.key(1),
                                            part.n_vertices))
    _assert_same_result(TA.etsch_cc(pt, ids=ids), RA.etsch_cc(part, key=1))


def test_etsch_cc_disconnected_graph():
    """Two rings, hash-partitioned (tests/test_etsch.py's case)."""
    n = 60
    u = np.arange(30)
    v = (u + 1) % 30
    edges = np.stack([np.concatenate([u, 30 + u]),
                      np.concatenate([v, 30 + v])], 1)
    g = RG.from_edge_array(n, edges)
    gt = TG.graph_from_numpy(g, device=CPU)
    part = RE.compile_partitioning(g, RB.hash_partition(g, 3), 3)
    pt = TE.Partitioning.from_reference(part, device=CPU)
    ids = np.asarray(jax.random.permutation(jax.random.key(0), n))
    res = TA.etsch_cc(pt, ids=ids)
    _assert_same_result(res, RA.etsch_cc(part, key=0))
    got = res.state.numpy()
    assert len(np.unique(got[:30])) == 1 and len(np.unique(got[30:])) == 1
    assert got[0] != got[30]
    # seeded ids of the port's own give the same components
    own = TA.etsch_cc(TE.compile_partitioning(gt, np.asarray(
        RB.hash_partition(g, 3)), 3, device=CPU), seed=3).state.numpy()
    assert len(np.unique(own[:30])) == 1 and own[0] != own[30]


def test_etsch_multi_sssp_bit_identical(setup):
    _, _, part, pt = setup
    sources = np.array([0, 7, 42, 499], np.int32)
    res = TA.etsch_multi_sssp(pt, sources)
    ref = RA.etsch_multi_sssp(part, jnp.asarray(sources))
    np.testing.assert_array_equal(res.dist.numpy(), np.asarray(ref.dist))
    assert res.supersteps == int(ref.supersteps)


def test_etsch_kcore_equal(setup):
    g, gt, part, pt = setup
    for k_core in (2, 3, 4):
        res = TA.etsch_kcore(pt, k_core)
        ref = RA.etsch_kcore(part, k_core)
        np.testing.assert_array_equal(res.in_core.numpy(),
                                      np.asarray(ref.in_core))
        assert res.supersteps == int(ref.supersteps)
        np.testing.assert_array_equal(TA.reference_kcore(gt, k_core).numpy(),
                                      np.asarray(RA.reference_kcore(g, k_core)))


def test_etsch_mis_equal(setup):
    g, gt, part, pt = setup
    key = jax.random.key(4)
    prio = np.asarray(jax.random.uniform(key, (part.n_vertices,),
                                         jnp.float32, 1e-6, 1.0))
    res = TA.etsch_mis(pt, prio=prio)
    ref = RA.etsch_mis(part, key)
    np.testing.assert_array_equal(res.in_set.numpy(), np.asarray(ref.in_set))
    assert res.supersteps == int(ref.supersteps)
    assert TA.is_independent_set(gt, res.in_set)
    assert TA.is_maximal_independent_set(gt, res.in_set)
    own = TA.etsch_mis(pt, seed=5).in_set      # the port's own draws
    assert TA.is_maximal_independent_set(gt, own)
    assert not TA.is_independent_set(gt, torch.ones_like(own))


def test_etsch_pagerank_within_tolerance(setup):
    g, gt, part, pt = setup
    got = TA.etsch_pagerank(pt, gt.degrees(), iters=25)
    want = RA.etsch_pagerank(part, g.degrees(), iters=25)
    assert got.supersteps == int(want.supersteps) == 25
    np.testing.assert_allclose(got.rank.numpy(), np.asarray(want.rank),
                               rtol=1e-5)
    np.testing.assert_allclose(TA.reference_pagerank(gt, iters=25).numpy(),
                               np.asarray(RA.reference_pagerank(g, iters=25)),
                               rtol=1e-5)


def test_vertex_centric_references_equal(setup):
    g, gt, _, _ = setup
    for source in (0, 250):
        d, r = TA.reference_sssp(gt, source)
        rd, rr = RA.reference_sssp(g, source)
        np.testing.assert_array_equal(d.numpy(), np.asarray(rd))
        assert r == int(rr)
    lab, r = TA.reference_cc(gt)
    rlab, rr = RA.reference_cc(g)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(rlab))
    assert r == int(rr)


def test_host_oracles_equal():
    """The host numpy oracles: the min programs bit-equal, the sums within
    1e-5 (float32 accumulated in another order)."""
    g = RG.watts_strogatz(200, 4, 0.1, seed=1)
    gt = TG.graph_from_numpy(g, device=CPU)
    rng = np.random.default_rng(0)
    n = g.n_vertices
    labels = rng.permutation(n).astype(np.float32)
    p = np.full(n, 1.0 / n, np.float32)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    w = rng.normal(size=(4, 3)).astype(np.float32)
    ent = rng.normal(size=(n, 4)).astype(np.float32)
    rel = rng.normal(size=(g.e_pad - 7, 4)).astype(np.float32)
    np.testing.assert_array_equal(TA.reference_weighted_sssp(gt, 3),
                                  RA.reference_weighted_sssp(g, 3))
    np.testing.assert_array_equal(TA.reference_label_propagation(gt, labels),
                                  RA.reference_label_propagation(g, labels))
    np.testing.assert_array_equal(TA.reference_bfs(gt, 3),
                                  RA.reference_bfs(g, 3))
    np.testing.assert_allclose(
        TA.reference_personalized_pagerank(gt, p),
        RA.reference_personalized_pagerank(g, p), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(TA.reference_gcn_layer(gt, x, w),
                               RA.reference_gcn_layer(g, x, w), atol=1e-5)
    np.testing.assert_allclose(TA.reference_kge_score(gt, ent, rel),
                               RA.reference_kge_score(g, ent, rel), atol=1e-5)


def test_etsch_on_cpu_launches_no_kernel(setup):
    """CPU tensors take the plain versions: no kernel launch is counted."""
    from repro_torch.kernels import ops
    _, _, _, pt = setup
    before = dict(ops.LAUNCHES)
    TA.etsch_sssp(pt, 0)
    assert ops.LAUNCHES == before

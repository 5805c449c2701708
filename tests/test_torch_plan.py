"""repro_torch.engine.plan against repro.engine.plan: every static and tensor
field of the compiled plan equal (values and dtypes), with and without
slack, and the replica accounting equal."""
import numpy as np
import pytest
import torch

import jax  # noqa: F401  (both frameworks in one process)

from repro import engine as E
from repro.core import baselines, dfep as RD
from repro.core import graph as RG
from repro_torch import engine as TE
from repro_torch.core import graph as TG
from repro_torch.engine import plan as TP

CPU = "cpu"

PROFILES = {
    "smallworld": lambda: RG.watts_strogatz(150, 4, 0.1, seed=1),
    "powerlaw": lambda: RG.largest_component(RG.barabasi_albert(120, 3,
                                                                seed=2)),
    "road": lambda: RG.largest_component(RG.road_network(10, 12, 0.25,
                                                         seed=3)),
}


@pytest.fixture(scope="module")
def graphs():
    return {name: build() for name, build in PROFILES.items()}


@pytest.fixture(scope="module")
def dfep_owner(graphs):
    g = graphs["powerlaw"]
    owner, _ = RD.partition(g, k=4, key=0, max_rounds=400, stall_rounds=16)
    return np.asarray(owner)


def assert_same_plan(want, got):
    for f in TP.STATIC_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    for f in TP.TENSOR_FIELDS:
        a = np.asarray(getattr(want, f))
        b = getattr(got, f).cpu().numpy()
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert got.exchange_volume == want.exchange_volume
    assert got.sum_local_vertices == want.sum_local_vertices
    assert got.replication_factor() == want.replication_factor()
    assert got.exchange_per_superstep() == want.exchange_per_superstep()


@pytest.mark.parametrize("slack", [(0, 0), (6, 4)])
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("profile", list(PROFILES))
def test_compile_plan_fields_equal(graphs, profile, k, slack):
    g = graphs[profile]
    owner = np.array(baselines.hash_partition(g, k))
    edge_slack, vertex_slack = slack
    want = E.compile_plan(g, owner, k, edge_slack=edge_slack,
                          vertex_slack=vertex_slack, epoch=3)
    got = TE.compile_plan(TG.graph_from_numpy(g, device=CPU),
                          torch.from_numpy(owner), k, edge_slack=edge_slack,
                          vertex_slack=vertex_slack, epoch=3, device=CPU)
    assert_same_plan(want, got)


@pytest.mark.parametrize("slack", [0, 8])
def test_compile_plan_from_dfep_owner(graphs, dfep_owner, slack):
    g = graphs["powerlaw"]
    want = E.compile_plan(g, dfep_owner, 4, edge_slack=slack,
                          vertex_slack=slack)
    got = TE.compile_plan(TG.graph_from_numpy(g, device=CPU), dfep_owner, 4,
                          edge_slack=slack, vertex_slack=slack, device=CPU)
    assert_same_plan(want, got)


def test_local_edges_roundtrip(graphs):
    g = graphs["smallworld"]
    owner = np.asarray(baselines.greedy_partition(g, 4, seed=0))
    want = E.compile_plan(g, owner, 4).local_edges()
    got = TE.compile_plan(TG.graph_from_numpy(g, device=CPU), owner, 4,
                          device=CPU).local_edges()
    assert len(got) == len(want) == 4
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)


def test_plan_from_numpy_converts_reference(graphs):
    g = graphs["road"]
    want = E.compile_plan(g, baselines.hash_partition(g, 4), 4,
                          edge_slack=3, vertex_slack=2)
    got = TE.plan_from_numpy(want, device=CPU)
    assert_same_plan(want, got)


def test_index64_is_widened_once(graphs):
    g = graphs["smallworld"]
    plan = TE.compile_plan(TG.graph_from_numpy(g, device=CPU),
                           baselines.hash_partition(g, 2), 2, device=CPU)
    a = plan.index64("edge_nbr")
    assert a.dtype == torch.int64 and plan.edge_nbr.dtype == torch.int32
    assert plan.index64("edge_nbr") is a
    assert torch.equal(a, plan.edge_nbr.long())


def test_compile_plan_rejects_bad_owner(graphs):
    g = graphs["smallworld"]
    gt = TG.graph_from_numpy(g, device=CPU)
    owner = np.asarray(baselines.hash_partition(g, 2)).copy()
    owner[0] = 5          # slot 0 is a real edge
    assert bool(g.edge_mask[0])
    with pytest.raises(ValueError):
        TE.compile_plan(gt, owner, 2, device=CPU)

"""repro_torch.core.metrics and .baselines against repro.core.metrics and
.baselines: ``evaluate`` equal field for field (floats equal, not close:
both compute them from the same integer counts in the same order), the
random, hash and greedy partitioners bit-equal, and JaBeJa bit-equal when
it is handed the reference's random draws."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import baselines as RB
from repro.core import dfep as RD
from repro.core import graph as RG
from repro.core import metrics as RM
from repro_torch import engine as TEng
from repro_torch.core import baselines as TB
from repro_torch.core import etsch as TE
from repro_torch.core import graph as TG
from repro_torch.core import metrics as TM

CPU = "cpu"


@pytest.fixture(scope="module")
def graphs():
    g = RG.watts_strogatz(300, 6, 0.1, seed=2)
    return g, TG.graph_from_numpy(g, device=CPU)


OWNERS = {
    "dfep": lambda g: RD.partition(g, k=4, key=0)[0],
    "hash": lambda g: RB.hash_partition(g, 4),
    "random": lambda g: RB.random_partition(g, 4, seed=1),
    "greedy": lambda g: RB.greedy_partition(g, 4, seed=0),
}


@pytest.mark.parametrize("name", sorted(OWNERS))
def test_evaluate_equal_field_for_field(graphs, name):
    g, gt = graphs
    owner = np.array(OWNERS[name](g))
    want = RM.evaluate(g, jnp.asarray(owner), 4, rounds=7)
    got = TM.evaluate(gt, torch.from_numpy(owner), 4, rounds=7)
    np.testing.assert_array_equal(got.sizes, want.sizes)
    for f in dataclasses.fields(RM.PartitionMetrics):
        if f.name != "sizes":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.row() == want.row()
    assert got.gain is not None
    # the identities tests/test_metrics_engine.py pins for the reference,
    # against the port's own plan
    plan = TEng.compile_plan(gt, owner, 4, device=CPU)
    assert got.messages == plan.exchange_volume
    assert got.replication_factor == plan.replication_factor()


def test_evaluate_with_a_given_partitioning_and_no_gain(graphs):
    g, gt = graphs
    owner = np.asarray(RB.hash_partition(g, 4))
    part = TE.compile_partitioning(gt, owner, 4, device=CPU)
    got = TM.evaluate(gt, owner, 4, part=part, compute_gain=False)
    want = RM.evaluate(g, owner, 4, compute_gain=False)
    assert got.row() == want.row() and got.gain is None


def test_connected_fraction_of_disconnected_partitions():
    """Two rings: partition 0 holds the first, partitions 1 and 2 split the
    second edge by edge, so each is in pieces. The fraction, 1/3, equals
    the reference's float32 quotient."""
    u = np.arange(30)
    v = (u + 1) % 30
    edges = np.stack([np.concatenate([u, 30 + u]),
                      np.concatenate([v, 30 + v])], 1)
    g = RG.from_edge_array(60, edges)
    gt = TG.graph_from_numpy(g, device=CPU)
    a = np.asarray(g.src)
    owner = np.where(a < 30, 0, 1 + a % 2).astype(np.int32)
    from repro.core.etsch import compile_partitioning
    want = RM.connected_fraction(compile_partitioning(g, owner, 3))
    got = TM.connected_fraction(TE.compile_partitioning(gt, owner, 3,
                                                        device=CPU))
    assert got == want == float(np.float32(1) / np.float32(3))


def test_nstdev_and_messages_small_cases():
    assert TM.nstdev(np.array([10, 10, 10, 10]), 40) == 0.0
    g = RG.from_edge_array(3, np.array([[0, 1], [1, 2]]))
    gt = TG.graph_from_numpy(g, device=CPU)
    owner = np.array([0, 1] + [-2] * (g.e_pad - 2), np.int32)
    m = TM.evaluate(gt, owner, 2, compute_gain=False)
    assert (m.messages, m.frontier_total) == (2, 1)


@pytest.mark.parametrize("k,seed", [(2, 0), (5, 3), (12, 10)])
def test_random_and_hash_partition_bit_equal(graphs, k, seed):
    g, gt = graphs
    got = TB.random_partition(gt, k, seed=seed)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(RB.random_partition(g, k, seed)))
    got = TB.hash_partition(gt, k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(RB.hash_partition(g, k)))


def test_hash_partition_bit_equal_at_large_ids():
    """uint32 wrap-around: vertex ids near 2^31 overflow 32 bits in both
    products of the hash."""
    n = 2**31 - 1
    edges = np.array([[n - 3, n - 2], [5, n - 7], [2**30, 2**30 + 9]])
    g = RG.from_edge_array(n, edges)
    gt = TG.from_edge_array(n, edges, device=CPU)
    np.testing.assert_array_equal(TB.hash_partition(gt, 7).numpy(),
                                  np.asarray(RB.hash_partition(g, 7)))


@pytest.mark.parametrize("k,seed", [(4, 0), (6, 1)])
def test_greedy_partition_bit_equal(k, seed):
    g = RG.barabasi_albert(300, 3, seed=0)
    gt = TG.graph_from_numpy(g, device=CPU)
    got = TB.greedy_partition(gt, k, seed=seed)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(RB.greedy_partition(g, k, seed)))


def _reference_jabeja_draws(g, k: int, seed: int, rounds: int):
    """The draws ``repro.core.baselines.jabeja_partition`` makes, rebuilt
    from its key splits (baselines.py:79-80, 100-101, 124-128), and its
    ``jnp.linspace`` temperatures, which differ from ``torch.linspace``'s
    in the last bit."""
    key = jax.random.key(seed)
    key, kc, ke = jax.random.split(key, 3)
    key, k0 = jax.random.split(kc)
    colors0 = jax.random.randint(k0, (g.n_vertices,), 0, k, dtype=jnp.int32)
    swaps = min(4096, g.n_vertices // 2)
    pairs = []
    for _ in range(rounds):
        key, k1, _ = jax.random.split(key, 3)
        pairs.append(np.asarray(jax.random.permutation(
            k1, g.n_vertices))[:2 * swaps])
    side = jax.random.bernoulli(ke, 0.5, (g.e_pad,))
    temps = jnp.linspace(2.0, 1.0, rounds)
    return (torch.from_numpy(np.array(colors0)),
            torch.from_numpy(np.stack(pairs).astype(np.int64)),
            torch.from_numpy(np.array(temps)),
            torch.from_numpy(np.array(side)))


@pytest.mark.parametrize("k,seed,rounds", [(5, 0, 60), (3, 2, 20)])
def test_jabeja_bit_equal_given_reference_draws(k, seed, rounds):
    g = RG.watts_strogatz(400, 6, 0.1, seed=0)
    gt = TG.graph_from_numpy(g, device=CPU)
    want, info = RB.jabeja_partition(g, k, seed=seed, rounds=rounds)
    got = TB.jabeja_from_draws(gt, *_reference_jabeja_draws(g, k, seed,
                                                            rounds))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    own, own_info = TB.jabeja_partition(gt, k, seed=seed, rounds=rounds)
    assert own_info == info == {"rounds": rounds}
    live = own.numpy()[gt.edge_mask.numpy()]
    assert live.min() >= 0 and live.max() < k

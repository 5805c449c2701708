"""repro_torch.core.graph against repro.core.graph: the generators build the
same edge arrays from the same seed, with the same fingerprint, degrees and
bit-equal edge weights."""
import numpy as np
import pytest
import torch

import jax  # noqa: F401  (both frameworks in one process)

from repro.core import graph as RG
from repro_torch.core import graph as TG

CPU = "cpu"

# (reference builder, port builder) at small sizes
GENERATORS = {
    "barabasi_albert": (lambda: RG.barabasi_albert(300, 3, seed=5),
                        lambda: TG.barabasi_albert(300, 3, seed=5, device=CPU)),
    "watts_strogatz": (lambda: RG.watts_strogatz(400, 6, 0.1, seed=3),
                       lambda: TG.watts_strogatz(400, 6, 0.1, seed=3,
                                                 device=CPU)),
    "road_network": (lambda: RG.road_network(12, 15, 0.25, seed=3),
                     lambda: TG.road_network(12, 15, 0.25, seed=3,
                                             device=CPU)),
    "erdos_renyi": (lambda: RG.erdos_renyi(200, 500, seed=7),
                    lambda: TG.erdos_renyi(200, 500, seed=7, device=CPU)),
    "largest_component": (
        lambda: RG.largest_component(RG.barabasi_albert(120, 3, seed=2)),
        lambda: TG.largest_component(TG.barabasi_albert(120, 3, seed=2,
                                                        device=CPU))),
    "remap_edges": (
        lambda: RG.remap_edges(RG.watts_strogatz(200, 4, 0.0, seed=1), 0.3,
                               seed=4),
        lambda: TG.remap_edges(TG.watts_strogatz(200, 4, 0.0, seed=1,
                                                 device=CPU), 0.3, seed=4)),
}

DATASETS = [("astroph", 0.05), ("email-enron", 0.03), ("usroads", 0.02),
            ("wordnet", 0.02), ("dblp", 0.005), ("amazon", 0.002)]


def assert_same_graph(ref, got):
    assert got.n_vertices == ref.n_vertices
    assert got.n_edges == ref.n_edges
    assert got.e_pad == ref.e_pad
    assert got.src.dtype == torch.int32 and got.dst.dtype == torch.int32
    assert got.edge_mask.dtype == torch.bool
    np.testing.assert_array_equal(got.src.numpy(), np.asarray(ref.src))
    np.testing.assert_array_equal(got.dst.numpy(), np.asarray(ref.dst))
    np.testing.assert_array_equal(got.edge_mask.numpy(),
                                  np.asarray(ref.edge_mask))
    assert got.fingerprint() == ref.fingerprint()
    np.testing.assert_array_equal(got.degrees().numpy(),
                                  np.asarray(ref.degrees()))


@pytest.mark.parametrize("name", list(GENERATORS))
def test_generators_match_reference(name):
    build_ref, build_port = GENERATORS[name]
    assert_same_graph(build_ref(), build_port())


@pytest.mark.parametrize("name,scale", DATASETS)
def test_load_dataset_matches_reference(name, scale):
    assert_same_graph(RG.load_dataset(name, scale=scale, seed=1),
                      TG.load_dataset(name, scale=scale, seed=1, device=CPU))


def test_from_edge_array_dedupes_and_pads():
    edges = np.array([[0, 1], [1, 0], [2, 2], [3, 1], [1, 3], [4, 0]])
    for pad_to in (None, 200):
        assert_same_graph(RG.from_edge_array(5, edges, pad_to=pad_to),
                          TG.from_edge_array(5, edges, pad_to=pad_to,
                                             device=CPU))
    with pytest.raises(ValueError):
        TG.from_edge_array(5, edges, pad_to=2, device=CPU)


def test_edge_weights_bit_equal():
    rng = np.random.default_rng(0)
    u = np.concatenate([rng.integers(0, 2**31 - 1, 5000),
                        [0, 1, 2**31 - 1, 1_000_002, 1_000_003]])
    v = np.concatenate([rng.integers(0, 2**31 - 1, 5000),
                        [0, 2**31 - 1, 0, 1_000_003, 7]])
    got, want = TG.edge_weights(u, v), RG.edge_weights(u, v)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_fingerprint_ignores_slot_order_and_padding():
    edges = np.array([[0, 1], [1, 2], [2, 3], [3, 0]])
    a = TG.from_edge_array(4, edges, device=CPU)
    b = TG.from_edge_array(4, edges[::-1], pad_to=512, device=CPU)
    assert a.fingerprint() == b.fingerprint()
    assert a.fingerprint() == RG.from_edge_array(4, edges).fingerprint()


def test_graph_from_numpy_converts_reference():
    ref = RG.watts_strogatz(150, 4, 0.1, seed=1)
    got = TG.graph_from_numpy(ref, device=CPU)
    assert_same_graph(ref, got)
    assert got.as_numpy()[0].dtype == np.int32

"""repro_torch.core.dfep against repro.core.dfep: for the same start
vertices the port sells the same edges in the same rounds — owner array,
round count and final funding identical — for plain DFEP, DFEP-C, and a run
cut short so that ``finalize`` assigns the rest."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import dfep as RD
from repro.core import graph as RG
from repro_torch.core import dfep as TD
from repro_torch.core import graph as TG

CPU = "cpu"

GRAPHS = {
    "powerlaw": lambda: RG.largest_component(RG.barabasi_albert(120, 3,
                                                                seed=2)),
    "smallworld": lambda: RG.watts_strogatz(300, 6, 0.1, seed=3),
}

# (graph, k, variant_c, max_rounds): full runs, DFEP-C, and runs cut after
# 5 rounds so that finalize assigns most edges
CASES = [("powerlaw", 2, False, 400), ("powerlaw", 4, False, 400),
         ("smallworld", 4, False, 400), ("powerlaw", 4, True, 400),
         ("smallworld", 2, True, 400), ("smallworld", 4, False, 5),
         ("powerlaw", 2, True, 5)]


def ref_starts(n_vertices: int, k: int, key: int = 0) -> np.ndarray:
    """The start vertices the reference's init_state draws."""
    return np.asarray(jax.random.choice(jax.random.key(key), n_vertices,
                                        shape=(k,), replace=False))


@pytest.fixture(scope="module")
def graphs():
    out = {}
    for name, build in GRAPHS.items():
        ref = build()
        out[name] = (ref, TG.graph_from_numpy(ref, device=CPU))
    return out


@pytest.fixture(scope="module")
def reference_runs(graphs):
    """Reference run_dfep states and partition() results, shared by the
    parity tests (each jit compile costs about a second)."""
    out = {}
    for name, k, vc, rounds in CASES:
        g = graphs[name][0]
        cfg = RD.DfepConfig(k=k, variant_c=vc, max_rounds=rounds,
                            stall_rounds=16)
        st = RD.run_dfep(g, RD.build_slots(g), cfg, jax.random.key(0))
        owner, info = RD.partition(g, k=k, key=0, variant_c=vc,
                                   max_rounds=rounds, stall_rounds=16)
        out[(name, k, vc, rounds)] = (st, np.asarray(owner), info)
    return out


def test_hash01_bit_equal_on_large_ids():
    e = np.array([0, 1, 2, 3, 12345, 2**20 + 7, 951_295, 1_234_567_890,
                  2**31 - 2, 2**31 - 1], np.int32)
    i = np.arange(0, 130, 7, dtype=np.int32)
    r = np.array([0, 1, 2, 63, 4000, 9999, 2**31 - 1], np.int32)
    ee, ii, rr = np.meshgrid(e, i, r, indexing="ij")
    want = np.asarray(RD._hash01(jnp.asarray(ee), jnp.asarray(ii),
                                 jnp.asarray(rr)))
    got = TD._hash01(torch.from_numpy(ee), torch.from_numpy(ii),
                     torch.from_numpy(rr)).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (got >= 0).all() and (got <= 1).all()


def test_build_slots_match_reference(graphs):
    ref, port = graphs["powerlaw"]
    want = RD.build_slots(ref)
    got = TD.build_slots(port)
    for field in ("edge", "vertex", "seg_first", "inv"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_run_dfep_state_identical(graphs, reference_runs, case):
    """owner, funding, rounds and stall count after the round loop."""
    name, k, vc, rounds = case
    ref, port = graphs[name]
    want = reference_runs[case][0]
    cfg = TD.DfepConfig(k=k, variant_c=vc, max_rounds=rounds,
                        stall_rounds=16)
    got = TD.run_dfep(port, TD.build_slots(port), cfg,
                      ref_starts(ref.n_vertices, k))
    np.testing.assert_array_equal(got.owner.numpy(), np.asarray(want.owner))
    np.testing.assert_array_equal(got.mv.numpy(), np.asarray(want.mv))
    assert int(got.rounds) == int(want.rounds)
    assert int(got.stalled) == int(want.stalled)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_partition_identical(graphs, reference_runs, case):
    """owner array and info after finalize and padding."""
    name, k, vc, rounds = case
    ref, port = graphs[name]
    _, want_owner, want_info = reference_runs[case]
    owner, info = TD.partition(port, k=k, starts=ref_starts(ref.n_vertices, k),
                               variant_c=vc, max_rounds=rounds,
                               stall_rounds=16, device=CPU)
    assert owner.dtype == torch.int32
    np.testing.assert_array_equal(owner.numpy(), want_owner)
    for field in ("rounds", "unsold_at_stop", "finalized"):
        assert info[field] == want_info[field]
    if rounds == 5:   # the cut-short cases really exercise finalize
        assert info["finalized"] and info["unsold_at_stop"] > 0


def test_finalize_matches_reference(graphs):
    """finalize alone, from a partial owner array with many FREE edges."""
    ref, port = graphs["smallworld"]
    rng = np.random.default_rng(0)
    em = np.asarray(ref.edge_mask)
    owner = np.where(rng.random(ref.e_pad) < 0.3, rng.integers(0, 4, ref.e_pad),
                     RD.FREE).astype(np.int32)
    owner = np.where(em, owner, -2).astype(np.int32)
    want = np.asarray(RD.finalize(ref, jnp.asarray(owner), 4))
    got = TD.finalize(port, torch.from_numpy(owner), 4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_seeded_starts_are_deterministic_and_distinct(graphs):
    _, port = graphs["powerlaw"]
    a, info_a = TD.partition(port, k=4, seed=3, max_rounds=50, device=CPU)
    b, info_b = TD.partition(port, k=4, seed=3, max_rounds=50, device=CPU)
    assert torch.equal(a, b) and info_a == info_b
    assert len(set(info_a["starts"])) == 4
    assert info_a["starts"] == TD.draw_starts(port.n_vertices, 4, 3).tolist()
    with pytest.raises(ValueError):
        TD.partition(port, k=4, starts=[0, 0, 1, 2], device=CPU)

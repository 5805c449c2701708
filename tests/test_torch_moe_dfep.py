"""repro_torch.core.moe_dfep against repro.core.moe_dfep on the CPU: the
co-activation graph's edges, DFEP's owner array and rounds on it, the
placement, its permutation, shard loads and imbalance, the contiguous
baseline's imbalance, and ``permute_expert_params`` keeping the port's MoE
output. The reference draws DFEP's start vertices from ``jax.random``; the
port is given the same ones (``ref_starts``), after which everything must
be identical. Routing tables come from numpy seeds.

Tolerances: none for the graph, owner, rounds, placement, permutation and
loads (exact; the imbalance is the same float64 division of equal loads).
The permuted MoE's output against the unpermuted one on the same input:
max |Δ| ≤ PERM_REL · max |y|, since renaming experts reorders each
token's float32 combine (ascending expert id), so a bfloat16 output near
a rounding boundary may round the other way.
"""
import numpy as np
import pytest
import torch

import jax

from repro.core import dfep as RD
from repro.core import moe_dfep as RM
from repro_torch.configs import get_config
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.core import moe_dfep as TM

CPU = "cpu"
PERM_REL = 1e-2


def ref_starts(n_vertices: int, k: int, key: int = 0) -> np.ndarray:
    """The start vertices the reference's ``dfep.partition(key=key)``
    draws."""
    return np.asarray(jax.random.choice(jax.random.key(key), n_vertices,
                                        shape=(k,), replace=False))


def _skewed_routing(t=8000, e=32, k=2, seed=0):
    """The reference test's Zipf-skewed selection with clustered
    co-activation (tests/test_moe_dfep.py)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / (np.arange(e) + 1.0)
    p /= p.sum()
    first = rng.choice(e, size=t, p=p)
    second = (first + rng.choice([1, 2, 3], size=t)) % e
    return np.stack([first, second], 1)


def _top4_routing(t=2000, e=60, seed=1):
    """Four distinct experts a token, skewed, as a top-4 router gives."""
    rng = np.random.default_rng(seed)
    p = 1.0 / (np.arange(e) + 4.0)
    p /= p.sum()
    return np.stack([rng.choice(e, size=4, replace=False, p=p)
                     for _ in range(t)])


ROUTINGS = {"zipf32_k4": (_skewed_routing, 32, 4),
            "top4_60_k8": (_top4_routing, 60, 8)}


@pytest.mark.parametrize("name", sorted(ROUTINGS))
def test_coactivation_graph_matches_reference(name):
    build, e, _ = ROUTINGS[name]
    eidx = build()
    for seed in (0, 3):
        want = RM.coactivation_graph(eidx, e, seed=seed)
        got = TM.coactivation_graph(eidx, e, seed=seed, device=CPU)
        assert (got.n_vertices, got.n_edges) == (want.n_vertices,
                                                 want.n_edges)
        for a, b in ((got.src, want.src), (got.dst, want.dst),
                     (got.edge_mask, want.edge_mask)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", sorted(ROUTINGS))
def test_place_experts_matches_reference(name):
    build, e, k = ROUTINGS[name]
    eidx = build()
    want = RM.place_experts(eidx, n_experts=e, k=k, seed=0)
    g = RM.coactivation_graph(eidx, e, seed=0)
    owner, info = RD.partition(g, k=k, key=0, max_rounds=2000,
                               stall_rounds=64)
    got = TM.place_experts(eidx, n_experts=e, k=k, seed=0,
                           starts=ref_starts(e, k), device=CPU)
    np.testing.assert_array_equal(got.owner, np.asarray(owner))
    assert got.info["rounds"] == info["rounds"]
    assert got.info["finalized"] == info["finalized"]
    np.testing.assert_array_equal(got.expert_to_shard, want.expert_to_shard)
    np.testing.assert_array_equal(got.permutation, want.permutation)
    np.testing.assert_array_equal(got.shard_load, want.shard_load)
    assert got.imbalance == want.imbalance
    # a valid placement: every expert once, capacity E/K respected
    assert sorted(got.permutation.tolist()) == list(range(e))
    assert np.bincount(got.expert_to_shard, minlength=k).max() <= -(-e // k)


def test_place_experts_beats_the_contiguous_layout():
    eidx = _skewed_routing()
    loads = np.bincount(eidx.reshape(-1), minlength=32).astype(float)
    got = TM.place_experts(eidx, n_experts=32, k=4, seed=0,
                           starts=ref_starts(32, 4), device=CPU)
    assert got.imbalance < TM.naive_imbalance(loads, 4)


@pytest.mark.parametrize("e,k", [(32, 4), (60, 8), (7, 3)])
def test_naive_imbalance_matches_reference(e, k):
    loads = np.random.default_rng(e).integers(0, 500, size=e).astype(float)
    assert TM.naive_imbalance(loads, k) == RM.naive_imbalance(loads, k)


def test_permute_expert_params_keeps_the_moe_output():
    """The reference test's check on the port: the SMOKE MoE layer with
    its experts and router columns permuted gives the same output, and
    the routing is the same up to the renaming."""
    cfg = get_config("qwen2-moe-a2.7b", smoke=True)
    params = TLM.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    moe_p = TLM._index(params["blocks"]["l0"]["ffn"], 0)
    x = (torch.randn((2, 8, cfg.d_model),
                     generator=torch.Generator().manual_seed(1)) * 0.1) \
        .to(torch.bfloat16)
    perm = np.random.default_rng(0).permutation(moe_p["router"].shape[1])
    moe_perm = TM.permute_expert_params(moe_p, perm)
    with TL.record_routing() as routes:
        y0, aux0 = TL.moe(cfg, moe_p, x)
        y1, aux1 = TL.moe(cfg, moe_perm, x)
    r0, r1 = routes
    assert torch.equal(torch.as_tensor(perm)[r1.expert_idx], r0.expert_idx)
    assert torch.equal(r0.keep, r1.keep)
    err = float((y1.float() - y0.float()).abs().max())
    assert err <= PERM_REL * float(y0.float().abs().max())
    assert abs(float(aux1) - float(aux0)) <= 1e-5 * float(aux0)
    # the shared expert is kept; the stacked [R, E, ...] layout permutes
    # axis ndim - 3 as the per-layer one does
    assert moe_perm["shared"] is moe_p["shared"]
    stacked = TM.permute_expert_params(params["blocks"]["l0"]["ffn"], perm)
    assert torch.equal(stacked["w_down"][1],
                       params["blocks"]["l0"]["ffn"]["w_down"][1][perm])
    assert torch.equal(stacked["router"][0], moe_perm["router"])


def test_permute_expert_params_matches_reference():
    """The same leaves permuted along the same axes as the reference."""
    rng = np.random.default_rng(2)
    p = {"router": rng.normal(size=(3, 16, 8)).astype(np.float32),
         "w_gate": rng.normal(size=(3, 8, 16, 4)).astype(np.float32),
         "w_up": rng.normal(size=(3, 8, 16, 4)).astype(np.float32),
         "w_down": rng.normal(size=(3, 8, 4, 16)).astype(np.float32)}
    perm = rng.permutation(8)
    want = RM.permute_expert_params(p, perm)
    got = TM.permute_expert_params({k: torch.from_numpy(v)
                                    for k, v in p.items()}, perm)
    for name in p:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))

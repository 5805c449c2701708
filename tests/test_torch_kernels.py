"""repro_torch.engine.kernels: the plain versions of ``segment_reduce`` and
``masked_update`` against the JAX package's Pallas kernels (interpret mode)
and ``segment_reduce_ref``, on fresh plans and on plans patched by
``repro.stream.patch.patch_plan`` (inserts into the append region,
deletions in the CSR prefix). min/max are bit-identical, add within 1e-5,
``masked_update`` exact. The CUDA kernels themselves run only on a card:
``tests/test_torch_gpu.py`` holds them against these plain versions."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import engine as E
from repro.core import baselines
from repro.core import graph as RG
from repro.engine import kernels as RK
from repro.stream.patch import EdgeChange, patch_plan
from repro_torch import cuda_build
from repro_torch import engine as TE
from repro_torch.engine import kernels as TK

CPU = "cpu"
COMBINES = ("min", "max", "add")
ADD_ATOL = 1e-5


def _patched(plan, g, owner, seed: int):
    """Delete a few live edges (holes in the CSR prefix) and insert new
    ones (appended into slack, each its own segment)."""
    rng = np.random.default_rng(seed)
    u, v = g.as_numpy()
    own = np.asarray(owner)[np.asarray(g.edge_mask)]
    dele = rng.choice(len(u), size=6, replace=False)
    changes = [EdgeChange(int(u[i]), int(v[i]), int(own[i]), -1)
               for i in dele]
    present = set(zip(u.tolist(), v.tolist()))
    while len(changes) < 6 + 10:
        a, b = sorted(rng.integers(0, g.n_vertices, 2).tolist())
        if a != b and (a, b) not in present:
            present.add((a, b))
            changes.append(EdgeChange(a, b, -1, int(rng.integers(0, plan.k))))
    return patch_plan(plan, changes)


@pytest.fixture(scope="module")
def plans():
    """name -> reference plan: fresh (no slack), and with slack before and
    after a patch."""
    g = RG.largest_component(RG.barabasi_albert(120, 3, seed=2))
    owner = baselines.hash_partition(g, 4)
    slack = E.compile_plan(g, owner, 4, edge_slack=12, vertex_slack=8)
    patched = _patched(slack, g, owner, seed=0)
    em = np.asarray(patched.emask)
    in_csr = np.arange(patched.e_max)[None, :] < np.asarray(
        patched.csr_fill)[:, None]
    assert (em & ~in_csr).any() and (~em & in_csr).any()
    k2 = RG.watts_strogatz(150, 4, 0.1, seed=1)
    return {"fresh": E.compile_plan(g, owner, 4),
            "fresh_k2": E.compile_plan(k2, baselines.hash_partition(k2, 2), 2),
            "slack": slack, "patched": patched}


def _messages(plan, features: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape = plan.emask.shape + ((features,) if features > 1 else ())
    m = rng.uniform(0.0, 10.0, shape).astype(np.float32)
    m[rng.random(shape) < 0.1] = np.inf          # unreached sources (SSSP)
    return m


@pytest.fixture(scope="module")
def reference_aggregates(plans):
    """(plan, features, combine) -> (messages, Pallas result, scatter ref)."""
    out = {}
    for name, plan in plans.items():
        for features in (1, 3):
            m = _messages(plan, features, seed=len(name) + features)
            for combine in COMBINES:
                mc = m if combine == "min" else np.where(np.isinf(m), 1.0, m)
                if combine == "add":   # rank/degree-sized, like PageRank's
                    mc = (mc / 100).astype(np.float32)
                got = RK.segment_reduce(plan, jnp.asarray(mc), combine)
                ref = RK.segment_reduce_ref(plan, jnp.asarray(mc), combine)
                out[(name, features, combine)] = (mc, np.asarray(got),
                                                  np.asarray(ref))
    return out


@pytest.mark.parametrize("features", [1, 3])
@pytest.mark.parametrize("name", ["fresh", "fresh_k2", "slack", "patched"])
def test_segment_reduce_plain_matches_reference(plans, reference_aggregates,
                                                name, features):
    plan = TE.plan_from_numpy(plans[name], device=CPU)
    for combine in COMBINES:
        m, pallas, scatter = reference_aggregates[(name, features, combine)]
        got = TK.segment_reduce_ref(plan, torch.from_numpy(m), combine)
        assert got.dtype == torch.float32 and got.shape == pallas.shape
        got = got.numpy()
        if combine == "add":
            np.testing.assert_allclose(got, pallas, rtol=0, atol=ADD_ATOL)
            np.testing.assert_allclose(got, scatter, rtol=0, atol=ADD_ATOL)
        else:
            np.testing.assert_array_equal(got, pallas)
            np.testing.assert_array_equal(got, scatter)


def test_segment_reduce_dispatches_plain_on_cpu(plans, reference_aggregates):
    """A CPU tensor runs the plain version and launches nothing."""
    plan = TE.plan_from_numpy(plans["patched"], device=CPU)
    m, _, _ = reference_aggregates[("patched", 1, "min")]
    before = dict(TK.LAUNCHES)
    got = TK.segment_reduce(plan, torch.from_numpy(m), "min")
    assert TK.LAUNCHES == before
    assert torch.equal(got, TK.segment_reduce_ref(plan, torch.from_numpy(m),
                                                  "min"))


@pytest.mark.parametrize("features", [1, 3])
@pytest.mark.parametrize("combine", COMBINES)
def test_masked_update_plain_matches_reference(plans, combine, features):
    ref_plan = plans["patched"]
    plan = TE.plan_from_numpy(ref_plan, device=CPU)
    rng = np.random.default_rng(7)
    tail = (features,) if features > 1 else ()
    state = rng.uniform(0, 5, (plan.k, plan.v_max) + tail).astype(np.float32)
    glob = rng.uniform(0, 5, (plan.n_vertices,) + tail).astype(np.float32)
    state[rng.random(state.shape) < 0.2] = np.inf
    incoming = jnp.asarray(glob)[ref_plan.local2global]
    want = np.asarray(RK.masked_update(jnp.asarray(state), incoming,
                                       ref_plan.vmask, ref_plan.replicated,
                                       combine))
    before = dict(TK.LAUNCHES)
    got = TK.masked_update(torch.from_numpy(state), torch.from_numpy(glob),
                           plan.local2global, plan.vmask, plan.replicated,
                           combine)
    assert TK.LAUNCHES == before
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        TK.masked_update_ref(torch.from_numpy(state), torch.from_numpy(glob),
                             plan.local2global, plan.vmask, plan.replicated,
                             combine).numpy(), want)


def test_wrappers_refuse_other_devices(plans):
    """No silent fallback: a tensor that is neither on the CPU nor on one
    CUDA device raises instead of running the plain version."""
    plan = TE.plan_from_numpy(plans["fresh"], device=CPU)
    meta = torch.empty(plan.emask.shape, device="meta")
    with pytest.raises(ValueError):
        TK.segment_reduce(plan, meta, "min")
    state = torch.empty((plan.k, plan.v_max), device="meta")
    with pytest.raises(ValueError):
        TK.masked_update(state, torch.zeros(plan.n_vertices),
                         plan.local2global, plan.vmask, plan.replicated)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(cuda_build, "DEFAULT_NVCC", tmp_path / "no-nvcc")
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.find_nvcc()


def test_library_path_keyed_by_source():
    paths = {n: cuda_build.library_path(n) for n in cuda_build.SIGNATURES}
    assert set(paths) == {"segment_reduce", "masked_update", "gspmm",
                          "replica_exchange", "lane_cumsum", "frontier_min",
                          "minplus_sweep", "selective_scan",
                          "selective_scan_bwd"}
    for name, path in paths.items():
        assert path.parent == cuda_build.BUILD_DIR
        assert path.name.startswith(name + "-") and path.suffix == ".so"
        assert (cuda_build.CSRC / f"{name}.cu").exists()

"""The whole slice: the port's DFEP → compile_plan → Engine against the JAX
pipeline and the oracles in ``repro.core.algorithms``. SSSP and WCC are
bit-identical with equal superstep, local-iteration, convergence and
exchange counters; PageRank within 1e-5. Also the package rules: the port
imports nothing of JAX or of ``repro``, and its entry points raise without
a card instead of running on the CPU."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from repro import engine as E
from repro.core import algorithms as alg
from repro.core import dfep as RD
from repro.core import graph as RG
from repro_torch import engine as TE
from repro_torch.core import dfep as TD
from repro_torch.core import graph as TG

CPU = "cpu"
PR_ATOL = 1e-5
SRC = Path(__file__).resolve().parents[1] / "src"

PROFILES = {
    "powerlaw": lambda: RG.largest_component(RG.barabasi_albert(120, 3,
                                                                seed=2)),
    "road": lambda: RG.largest_component(RG.road_network(10, 12, 0.25,
                                                         seed=3)),
}
CASES = [("powerlaw", 2), ("powerlaw", 4), ("road", 4)]
SOURCE = 3


def _row(r) -> dict:
    return {"supersteps": int(r.supersteps), "local_iters": int(r.local_iters),
            "converged": bool(r.converged),
            "exchange_per_superstep": int(r.exchange_per_superstep),
            "total_exchanged": int(r.total_exchanged)}


@pytest.fixture(scope="module")
def pipelines():
    """(profile, k) -> (reference graph, reference owner, reference results,
    port graph, port owner, port results)."""
    out = {}
    graphs = {name: build() for name, build in PROFILES.items()}
    for name, k in CASES:
        g = graphs[name]
        owner, _ = RD.partition(g, k=k, key=0, max_rounds=400,
                                stall_rounds=16)
        eng = E.Engine(E.compile_plan(g, owner, k))
        ref = {"sssp": E.engine_sssp(eng, SOURCE), "wcc": E.engine_wcc(eng),
               "pagerank": E.engine_pagerank(eng, g.degrees())}
        gt = TG.graph_from_numpy(g, device=CPU)
        starts = np.asarray(jax.random.choice(jax.random.key(0), g.n_vertices,
                                              shape=(k,), replace=False))
        owner_t, _ = TD.partition(gt, k=k, starts=starts, max_rounds=400,
                                  stall_rounds=16, device=CPU)
        eng_t = TE.Engine(TE.compile_plan(gt, owner_t, k, device=CPU))
        port = {"sssp": TE.engine_sssp(eng_t, SOURCE),
                "wcc": TE.engine_wcc(eng_t),
                "pagerank": TE.engine_pagerank(eng_t, gt.degrees())}
        out[(name, k)] = (g, np.asarray(owner), ref, gt, owner_t, port)
    return out


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-k{c[1]}")
def test_slice_matches_jax_pipeline(pipelines, case):
    g, owner, ref, gt, owner_t, port = pipelines[case]
    np.testing.assert_array_equal(owner_t.numpy(), owner)
    for name in ("sssp", "wcc"):
        np.testing.assert_array_equal(port[name].state.numpy(),
                                      np.asarray(ref[name].state))
        assert port[name].row() == _row(ref[name]), name
    np.testing.assert_allclose(port["pagerank"].state.numpy(),
                               np.asarray(ref["pagerank"].state), rtol=0,
                               atol=PR_ATOL)
    assert port["pagerank"].row() == _row(ref["pagerank"])


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-k{c[1]}")
def test_slice_matches_oracles(pipelines, case):
    g, _, _, _, _, port = pipelines[case]
    np.testing.assert_array_equal(port["sssp"].state.numpy(),
                                  np.asarray(alg.reference_sssp(g, SOURCE)[0]))
    np.testing.assert_array_equal(port["wcc"].state.numpy(),
                                  np.asarray(alg.reference_cc(g)[0]))
    np.testing.assert_allclose(port["pagerank"].state.numpy(),
                               np.asarray(alg.reference_pagerank(g)), rtol=0,
                               atol=PR_ATOL)


def test_plain_and_kernel_engines_agree_on_cpu(pipelines):
    """use_kernels=False runs the plain versions everywhere; on CPU tensors
    the kernel wrappers run the same plain versions."""
    _, _, _, gt, owner_t, port = pipelines[("powerlaw", 4)]
    eng = TE.Engine(TE.compile_plan(gt, owner_t, 4, device=CPU),
                    use_kernels=False)
    for name, r in (("sssp", TE.engine_sssp(eng, SOURCE)),
                    ("wcc", TE.engine_wcc(eng)),
                    ("pagerank", TE.engine_pagerank(eng, gt.degrees()))):
        assert torch.equal(r.state, port[name].state), name
        assert r.row() == port[name].row()


def test_superstep_cap_reports_nonconvergence():
    n = 60  # path graph with alternating edge ownership: slow cut crossings
    edges = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    g = TG.from_edge_array(n, edges, device=CPU)
    owner = torch.where(g.edge_mask, g.src % 2, -2)
    eng = TE.Engine(TE.compile_plan(g, owner, 2, device=CPU))
    trunc = eng.run(TE.SSSP, max_supersteps=3, source=0)
    assert not trunc.converged and not trunc.row()["converged"]
    assert trunc.supersteps == 3
    full = TE.engine_sssp(eng, 0)
    assert full.converged
    ref, _ = alg.reference_sssp(RG.from_edge_array(n, edges), 0)
    np.testing.assert_array_equal(full.state.numpy(), np.asarray(ref))


def _one_sweep_pair(case, pipelines):
    """(reference engine, port engine, source) for the local-cap cases."""
    if case == "two-vertex":
        edges = np.array([[0, 1]])
        g = RG.from_edge_array(2, edges)
        owner = np.where(np.asarray(g.edge_mask), 0, -2).astype(np.int32)
        gt = TG.from_edge_array(2, edges, device=CPU)
        owner_t = torch.as_tensor(owner)
        return (E.Engine(E.compile_plan(g, owner, 1)),
                TE.Engine(TE.compile_plan(gt, owner_t, 1, device=CPU)), 0)
    g, owner, _, gt, owner_t, _ = pipelines[("powerlaw", 4)]
    return (E.Engine(E.compile_plan(g, owner, 4)),
            TE.Engine(TE.compile_plan(gt, owner_t, 4, device=CPU)), SOURCE)


@pytest.mark.parametrize("max_local_iters", [0, 1])
@pytest.mark.parametrize("case", ["two-vertex", "powerlaw-k4"])
def test_one_sweep_program_ignores_local_cap(pipelines, case,
                                             max_local_iters):
    """A replica program without a local fixed point runs exactly one sweep
    a superstep, whatever ``max_local_iters`` is, as the reference does."""
    eng, eng_t, source = _one_sweep_pair(case, pipelines)
    ref = eng.run(E.SSSP._replace(local_fixpoint=False),
                  max_local_iters=max_local_iters, source=source)
    port = eng_t.run(TE.SSSP._replace(local_fixpoint=False),
                     max_local_iters=max_local_iters, source=source)
    np.testing.assert_array_equal(port.state.numpy(), np.asarray(ref.state))
    assert port.row() == _row(ref)
    assert port.local_iters == port.supersteps
    if case == "two-vertex":
        np.testing.assert_array_equal(port.state.numpy(), [0.0, 1.0])
        assert (port.supersteps, port.local_iters) == (2, 2)


def test_zero_supersteps_is_zero():
    g = TG.watts_strogatz(64, 4, 0.1, seed=0, device=CPU)
    owner = (g.src + g.dst) % 2
    eng = TE.Engine(TE.compile_plan(g, owner, 2, device=CPU))
    r = TE.engine_pagerank(eng, g.degrees(), iters=0)
    assert r.supersteps == 0
    np.testing.assert_allclose(r.state.numpy(),
                               np.full(g.n_vertices, 1.0 / g.n_vertices))


def test_dispatch_returns_finished_result(pipelines):
    _, _, _, gt, owner_t, port = pipelines[("powerlaw", 2)]
    eng = TE.Engine(TE.compile_plan(gt, owner_t, 2, device=CPU))
    r = eng.dispatch(TE.SSSP, source=SOURCE).result()
    assert torch.equal(r.state, port["sssp"].state)
    warm = eng.run(TE.SSSP, warm_state=r.state, source=SOURCE)
    assert torch.equal(warm.state, r.state) and warm.supersteps == 1
    with pytest.raises(TE.WarmStateError):
        eng.run(TE.SSSP, warm_state=r.state[:-1], source=SOURCE)
    with pytest.raises(TE.WarmStateError):
        eng.run(TE.WCC, warm_state=r.state)


def test_package_imports_no_jax_and_no_reference():
    """A fresh interpreter that imports every module of repro_torch has
    loaded no ``jax`` and no ``repro`` module."""
    code = (
        "import json, pkgutil, sys, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "mods = sorted(n for n in sys.modules if n.startswith('repro_torch'))\n"
        "print(json.dumps({'bad': bad, 'mods': mods}))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen["bad"] == []
    for mod in ("repro_torch.core.dfep", "repro_torch.core.graph",
                "repro_torch.engine.kernels", "repro_torch.engine.plan",
                "repro_torch.engine.runtime", "repro_torch.engine.programs",
                "repro_torch.cuda_build", "repro_torch.kernels.ops",
                "repro_torch.core.etsch", "repro_torch.core.algorithms",
                "repro_torch.core.metrics", "repro_torch.core.baselines",
                "repro_torch.configs", "repro_torch.models.ssm",
                "repro_torch.models.lm", "repro_torch.serve.serve_step",
                "repro_torch.launch.serve", "repro_torch.engine.registry",
                "repro_torch.obs.recorder", "repro_torch.gserve.server"):
        assert mod in seen["mods"]


def test_entry_points_raise_without_a_card(monkeypatch):
    """device=None means CUDA; with no card the entry points raise rather
    than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    edges = np.array([[0, 1], [1, 2], [2, 0]])
    with pytest.raises(RuntimeError, match="CUDA"):
        TG.from_edge_array(3, edges)
    with pytest.raises(RuntimeError, match="CUDA"):
        TG.load_dataset("dblp", scale=0.01)
    g = TG.from_edge_array(3, edges, device=CPU)
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.partition(g, k=2)
    owner = torch.zeros(g.e_pad, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        TE.compile_plan(g, owner, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        TG.graph_from_numpy(g)

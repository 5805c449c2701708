"""The CUDA kernels of repro_torch against their plain PyTorch versions, on
the card. Marked ``gpu``: each test decides inside itself whether a CUDA
device is present and skips without one. This file imports no ``jax`` (the
machine with the card has none), so it builds its plans with the port
itself; the CPU files ``test_torch_*.py`` hold those plain versions and
plans against the JAX package.

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import engine as TE
from repro_torch.core import dfep as TD
from repro_torch.core import graph as TG
from repro_torch.engine import kernels as TK

COMBINES = ("min", "max", "add")
ADD_ATOL = 1e-5


def _card() -> str:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return "cuda"


def _patched(plan, seed: int, arrivals: int = 3):
    """What the streaming patch path leaves: a few CSR prefix slots deleted,
    a few vertices arrived into free vertex slots (``last_slot`` at the
    identity pad slot), and half-edges appended into ``[csr_fill,
    e_max-1)``, each its own segment, targeting old and arrived vertices."""
    rng = np.random.default_rng(seed)
    emask = plan.emask.cpu().numpy().copy()
    seg = plan.seg_start.cpu().numpy().copy()
    tgt = plan.edge_tgt.cpu().numpy().copy()
    vmask = plan.vmask.cpu().numpy().copy()
    fill = plan.csr_fill.cpu().numpy()
    n_local = plan.n_local.cpu().numpy()
    for k in range(plan.k):
        live = np.flatnonzero(emask[k, :fill[k]])
        emask[k, rng.choice(live, size=min(4, len(live)), replace=False)] = 0
        n_live = min(int(n_local[k]) + arrivals, plan.v_max)
        vmask[k, :n_live] = True
        free = np.arange(fill[k], plan.e_max - 1)
        new = rng.choice(free, size=len(free) // 2, replace=False)
        emask[k, new] = seg[k, new] = True
        tgt[k, new] = rng.integers(0, n_live, len(new))
    dev = plan.device
    return dataclasses.replace(
        plan, emask=torch.from_numpy(emask).to(dev),
        seg_start=torch.from_numpy(seg).to(dev),
        edge_tgt=torch.from_numpy(tgt).to(dev),
        vmask=torch.from_numpy(vmask).to(dev))


def _plans(dev: str) -> dict:
    g = TG.largest_component(TG.barabasi_albert(400, 3, seed=2, device=dev))
    owner, _ = TD.partition(g, k=4, seed=0, max_rounds=400, stall_rounds=16,
                            device=dev)
    slack = TE.compile_plan(g, owner, 4, edge_slack=24, vertex_slack=8,
                            device=dev)
    return {"fresh": TE.compile_plan(g, owner, 4, device=dev),
            "patched": _patched(slack, seed=0)}


@pytest.mark.gpu
def test_segment_reduce_matches_plain_on_card():
    """min/max exact, add within 1e-5 (another summation order, on
    rank/degree-sized messages like PageRank's); one launch per call;
    fresh and patched plans, scalar and F=3 messages."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, plan in _plans(dev).items():
        for features in (1, 3):
            shape = tuple(plan.emask.shape) + ((features,) if features > 1
                                               else ())
            m = torch.rand(shape, generator=gen, device=dev)
            m_min = torch.where(torch.rand(shape, generator=gen, device=dev)
                                < 0.1, float("inf"), m * 10)
            for combine in COMBINES:
                msgs = {"min": m_min, "max": m, "add": m / 100}[combine]
                before = TK.LAUNCHES["segment_reduce"]
                got = TK.segment_reduce(plan, msgs, combine)
                want = TK.segment_reduce_ref(plan, msgs, combine)
                torch.cuda.synchronize()
                assert TK.LAUNCHES["segment_reduce"] == before + 1
                if combine == "add":
                    torch.testing.assert_close(got, want, rtol=0,
                                               atol=ADD_ATOL)
                else:
                    assert torch.equal(got, want), (name, features, combine)


@pytest.mark.gpu
def test_masked_update_matches_plain_on_card():
    """Exact, for scalar and F=3 state; one launch per call."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(1)
    plan = _plans(dev)["patched"]
    for features in (1, 3):
        tail = (features,) if features > 1 else ()
        state = torch.rand((plan.k, plan.v_max) + tail, generator=gen,
                           device=dev)
        glob = torch.rand((plan.n_vertices,) + tail, generator=gen,
                          device=dev)
        args = (state, glob, plan.local2global, plan.vmask, plan.replicated)
        for combine in COMBINES:
            before = TK.LAUNCHES["masked_update"]
            got = TK.masked_update(*args, combine)
            torch.cuda.synchronize()
            assert TK.LAUNCHES["masked_update"] == before + 1
            assert torch.equal(got, TK.masked_update_ref(*args, combine))


@pytest.mark.gpu
def test_engine_on_card_equals_cpu():
    """The whole slice on the card equals the port on the CPU: DFEP owner
    and rounds, SSSP/WCC bit-identical with equal counters."""
    dev = _card()
    out = {}
    for d in (dev, "cpu"):
        g = TG.largest_component(TG.barabasi_albert(400, 3, seed=2,
                                                    device=d))
        owner, info = TD.partition(g, k=4, seed=0, max_rounds=400,
                                   stall_rounds=16, device=d)
        eng = TE.Engine(TE.compile_plan(g, owner, 4, device=d))
        out[d] = (owner.cpu(), info["rounds"], TE.engine_sssp(eng, 0),
                  TE.engine_wcc(eng))
    assert torch.equal(out[dev][0], out["cpu"][0])
    assert out[dev][1] == out["cpu"][1]
    for i in (2, 3):
        assert torch.equal(out[dev][i].state.cpu(), out["cpu"][i].state)
        assert out[dev][i].row() == out["cpu"][i].row()

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
#: segment_reduce add on a hub's run: ~1,500 float32 terms summed in a
#: block's shuffle tree against the plain version's atomic order.
HUB_ADD_RTOL = 1e-5


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


def _hub_plan(dev: str, leaves: int = 3000):
    """A star of ``leaves`` leaves on a ring, split in two partitions: the
    hub's run in each is ~leaves / 2 slots, which the kernels hand to their
    long-run (block per run) paths."""
    n = leaves + 1
    star = np.stack([np.zeros(leaves, np.int64), np.arange(1, n)], 1)
    ring = np.stack([np.arange(1, n), np.arange(2, n + 1) % n], 1)
    ring = ring[ring[:, 1] > 0]
    g = TG.from_edge_array(n, np.concatenate([star, ring]), device=dev)
    owner = torch.where(g.edge_mask, g.dst % 2, -2)
    return TE.compile_plan(g, owner, 2, device=dev)


@pytest.mark.gpu
def test_segment_reduce_matches_plain_on_card():
    """min/max exact; add within 1e-5 absolute on rank/degree-sized
    messages like PageRank's (another summation order), and on the hub
    plan, whose ~1,500-term sums pass that, within HUB_ADD_RTOL; two add
    calls give the same bits; one launch per call; fresh and patched
    plans and a hub plan whose run goes to a block of its own; scalar,
    F=3 and F=64 messages (at F=64 the tiles read their windows from
    device memory: they do not fit in shared memory). A call runs one
    CUDA kernel and allocates its output and nothing else: the layout was
    built with the plan."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    plans = dict(_plans(dev), hub=_hub_plan(dev))
    assert "_segment_layout" in plans["hub"].__dict__
    assert TK.segment_layout(plans["hub"]).n_units > 0
    for name, plan in plans.items():
        for features in (1, 3, 64):
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
                    rtol, atol = (HUB_ADD_RTOL, 0.0) if name == "hub" \
                        else (0.0, ADD_ATOL)
                    torch.testing.assert_close(got, want, rtol=rtol,
                                               atol=atol)
                    assert torch.equal(
                        TK.segment_reduce(plan, msgs, combine), got), name
                else:
                    assert torch.equal(got, want), (name, features, combine)
    plan = plans["hub"]
    msgs = torch.rand(tuple(plan.emask.shape), generator=gen, device=dev)
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    TK.segment_reduce(plan, msgs, "add")
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] \
        == allocs + 1                                   # the output alone
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        TK.segment_reduce(plan, msgs, "add")
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "seg_kernel" in kernels[0], kernels


@pytest.mark.gpu
def test_masked_update_matches_plain_on_card():
    """Exact, for scalar, F=3 and F=8 (the GNN programs' loop state)
    state; one launch per call."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(1)
    plan = _plans(dev)["patched"]
    for features in (1, 3, 8):
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


def _exchange_plans(dev: str) -> dict:
    """The exchange's plans: fresh and patched; a hub in all 16 partitions
    (a star on a path, each edge owned by ``dst % 16``); partition 2 of 3
    with no edge; that plan with a dead vertex slot a partition (Vmax % 4
    == 1 and K·Vmax % 4 == 3: partitions not 16-byte aligned, and a last
    thread of F = 1 with fewer than four slots)."""
    plans = _plans(dev)
    leaves = 600
    star = np.stack([np.zeros(leaves, np.int64), np.arange(1, leaves + 1)],
                    1)
    path = np.stack([np.arange(1, leaves), np.arange(2, leaves + 1)], 1)
    g = TG.from_edge_array(leaves + 1, np.concatenate([star, path]),
                           device=dev)
    plans["hub_all"] = TE.compile_plan(
        g, torch.where(g.edge_mask, g.dst % 16, -2), 16, device=dev)
    plans["empty_part"] = TE.compile_plan(
        g, torch.where(g.edge_mask, g.dst % 2, -2), 3, device=dev)
    p = plans["empty_part"]

    def grow(t, fill):
        return torch.cat([t, torch.full((p.k, 1), fill, dtype=t.dtype,
                                        device=t.device)], 1)
    plans["odd_vmax"] = dataclasses.replace(
        p, v_max=p.v_max + 1, local2global=grow(p.local2global, 0),
        vmask=grow(p.vmask, False), last_slot=grow(p.last_slot, p.e_max - 1),
        replicated=grow(p.replicated, False),
        is_master=grow(p.is_master, False))
    return plans


@pytest.mark.gpu
def test_exchange_matches_plain_on_card():
    """The kernel against the layout's plain walk, bit for bit for every
    combine (the same float32 operations in the same order), and against
    the reference chain ``exchange_ref``: min and max bit-exact, add within
    1e-5 and two add calls the same bits. Fresh, patched, hub-in-all-16,
    empty-partition and Vmax % 4 == 1 plans; F = 1, 3, 8, 16, and 1 and 8
    in planes that are not 16-byte aligned. Exactly one ``exchange`` launch a
    call, one CUDA kernel, and the output its only allocation (the layout
    was built with the plan, or at the first call)."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(3)
    plans = _exchange_plans(dev)
    assert "_exchange_layout" in plans["hub_all"].__dict__
    assert TK.exchange_layout(plans["hub_all"]).largest == 16
    for name, plan in plans.items():
        for features in (1, 3, 8, 16, -1, -8):
            shape = (plan.k, plan.v_max) + ((abs(features),)
                                            if abs(features) != 1 else ())
            x = torch.rand(shape, generator=gen, device=dev)
            if features < 0:          # 4-byte aligned only
                flat = torch.empty(x.numel() + 1, device=dev)
                x = flat[1:].view(shape).copy_(x)
            inf = torch.rand(shape, generator=gen, device=dev) < 0.2
            for combine in COMBINES:
                vals = {"min": torch.where(inf, float("inf"), x * 10),
                        "max": x, "add": x / 100}[combine]
                before = dict(TK.LAUNCHES)
                got = TK.exchange(plan, vals, combine)
                torch.cuda.synchronize()
                assert TK.LAUNCHES["exchange"] == before["exchange"] + 1
                assert TK.LAUNCHES["masked_update"] == \
                    before["masked_update"]
                key = (name, features, combine)
                assert got.shape == vals.shape, key
                assert torch.equal(got, TK.exchange_layout_ref(
                    plan, vals, combine)), key
                want = TK.exchange_ref(plan, vals, combine)
                if combine == "add":
                    torch.testing.assert_close(got, want, rtol=0,
                                               atol=ADD_ATOL, msg=str(key))
                    assert torch.equal(TK.exchange(plan, vals, combine),
                                       got), key
                else:
                    assert torch.equal(got, want), key
    plan = plans["hub_all"]
    x = torch.rand((plan.k, plan.v_max, 8), generator=gen, device=dev)
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    TK.exchange(plan, x, "add")
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] \
        == allocs + 1                                   # the output alone
    for _ in range(3):   # a profiler session that recorded nothing again
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            TK.exchange(plan, x, "add")
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    assert len(kernels) == 1 and "exchange_kernel" in kernels[0], kernels


@pytest.mark.gpu
def test_exchange_graph_replays_on_card():
    """One add exchange on the hub-in-all-16 plan and one at F = 1 on the
    Vmax % 4 == 1 plan, captured in a CUDA graph and replayed on three
    value planes: each output equals the eager call's, bit for bit."""
    dev = _card()
    plans = _exchange_plans(dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    for name, tail in (("hub_all", (8,)), ("odd_vmax", ())):
        plan = plans[name]
        TK.exchange_layout(plan)            # built outside the capture
        planes = [torch.rand((plan.k, plan.v_max) + tail, generator=gen,
                             device=dev) for _ in range(3)]
        _replays_equal(lambda x, p=plan: TK.exchange(p, x, "add"),
                       planes[0].clone(), planes,
                       lambda x, p=plan: TK.exchange(p, x.to(dev),
                                                     "add").cpu())


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


def _wider(plan, pad: int):
    """``plan`` with ``pad`` dead slots appended to every partition's edge
    stream (in its append region): with Emax not a multiple of 4, no
    partition after the first starts 16-byte aligned."""
    def grow(t, fill):
        return torch.cat([t, torch.full((plan.k, pad), fill, dtype=t.dtype,
                                        device=t.device)], 1)
    return dataclasses.replace(
        plan, e_max=plan.e_max + pad, edge_tgt=grow(plan.edge_tgt, 0),
        edge_nbr=grow(plan.edge_nbr, 0), emask=grow(plan.emask, False),
        seg_start=grow(plan.seg_start, False), edge_w=grow(plan.edge_w, 1.0),
        edge_slot=grow(plan.edge_slot, -1))


@pytest.mark.gpu
def test_gspmm_matches_plain_on_card():
    """max exact; add and mean within 1e-4 relative (non-negative terms, up
    to ~10^3 per run, summed in another order: a tile's groups in slot
    order, a hub's chunks in chunk order), and two add calls give the same
    bits; one gspmm launch per call, and mean adds one segment_reduce
    launch for the degree. Fresh, patched and hub plans (the hub's run is
    cut into chunks whose partial rows the last block combines); widths 1
    (rank-2 feats), 3, 8, 40, 40 in a plane that is not 16-byte aligned
    (two passes of a warp's 32 floats) and 128, and 256 (two passes of a
    warp's 128) on the hub plan; scalar and per-feature weights. Each
    plan also widened by two dead slots a partition (Emax % 4 == 2), where
    the tiles stage their windows a slot at a time: 16-byte loads would be
    misaligned there. A call runs one CUDA kernel and allocates its output
    and the hub's partial rows, nothing else: the layout was built with
    the plan."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(2)
    plans = dict(_plans(dev), hub=_hub_plan(dev, leaves=5 * TK.GS_CHUNK))
    assert "_gspmm_layout" in plans["hub"].__dict__
    assert TK.gspmm_layout(plans["hub"]).split
    plans.update({f"{name}_wide": _wider(plan, 2)
                  for name, plan in plans.items()})
    for name, plan in plans.items():
        widths = (1, 3, 8, 40, -40, 128) + ((256,) if name == "hub" else ())
        for features in widths:
            feats = torch.rand((plan.k, plan.v_max, abs(features)),
                               generator=gen, device=dev)
            if features < 0:     # 4-byte aligned only: 40 floats a lane
                flat = torch.empty(feats.numel() + 1, device=dev)
                feats = flat[1:].view(feats.shape).copy_(feats)
                features = -features
            if features == 1:
                feats = feats[:, :, 0]
            wide = torch.rand(tuple(plan.emask.shape) + (features,),
                              generator=gen, device=dev)
            for w in (plan.edge_w, wide):
                for combine in ("add", "max", "mean"):
                    before = dict(TK.LAUNCHES)
                    got = TK.gspmm(plan, feats, w, combine)
                    want = TK.gspmm_ref(plan, feats, w, combine)
                    torch.cuda.synchronize()
                    assert TK.LAUNCHES["gspmm"] == before["gspmm"] + 1
                    assert TK.LAUNCHES["segment_reduce"] == \
                        before["segment_reduce"] + (combine == "mean")
                    assert got.shape == (plan.k, plan.v_max, features)
                    key = (name, features, w.ndim, combine)
                    if combine == "max":
                        assert torch.equal(got, want), key
                    else:
                        torch.testing.assert_close(got, want, rtol=1e-4,
                                                   atol=1e-6, msg=str(key))
                    if combine == "add":
                        assert torch.equal(TK.gspmm(plan, feats, w, combine),
                                           got), key
    plan = plans["hub"]
    feats = torch.rand((plan.k, plan.v_max, 8), generator=gen, device=dev)
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    TK.gspmm(plan, feats, plan.edge_w, "add")
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] \
        == allocs + 2                           # the output and the partials
    for _ in range(3):   # a profiler session that recorded nothing again
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            TK.gspmm(plan, feats, plan.edge_w, "add")
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    assert len(kernels) == 1 and "gspmm_kernel" in kernels[0], kernels


@pytest.mark.gpu
def test_gspmm_graph_replays_on_card():
    """One add call on the hub plan (its hub run split into chunks, whose
    last arrival wraps the unit's counter back to 0) captured in a CUDA graph
    and replayed on three feature planes: each output equals the eager
    call's, bit for bit."""
    dev = _card()
    plan = _hub_plan(dev, leaves=5 * TK.GS_CHUNK)
    assert TK.gspmm_layout(plan).split
    gen = torch.Generator(device=dev).manual_seed(5)
    planes = [torch.rand((plan.k, plan.v_max, 8), generator=gen, device=dev)
              for _ in range(3)]
    _replays_equal(lambda x: TK.gspmm(plan, x, plan.edge_w, "add"),
                   planes[0].clone(), planes,
                   lambda x: TK.gspmm(plan, x.to(dev), plan.edge_w,
                                      "add").cpu())


@pytest.mark.gpu
def test_gnn_programs_on_card_match_cpu():
    """The slice's programs on the card equal the port on the CPU: wsssp,
    BFS and labelprop bit-identical with equal counters; PPR within 1e-4
    relative element by element (positive ranks), gcn_layer and kge_score
    within 1e-4 relative of the largest value (other summation orders;
    their outputs change sign); gcn_layer and kge_score launch gspmm."""
    dev = _card()
    rng = np.random.default_rng(0)
    out, inputs = {}, None
    for d in (dev, "cpu"):
        g = TG.largest_component(TG.barabasi_albert(400, 3, seed=2,
                                                    device=d))
        owner, _ = TD.partition(g, k=4, seed=0, max_rounds=400,
                                stall_rounds=16, device=d)
        eng = TE.Engine(TE.compile_plan(g, owner, 4, device=d))
        if inputs is None:
            v = g.n_vertices
            inputs = {
                "labels": rng.permutation(v).astype(np.float32),
                "p": np.full(v, 1.0 / v, np.float32),
                "x": rng.normal(size=(v, TE.GCN_F_IN)).astype(np.float32),
                "w": rng.normal(size=(TE.GCN_F_IN, TE.GCN_F_OUT)).astype(
                    np.float32),
                "ent": rng.normal(size=(v, TE.KGE_F)).astype(np.float32),
                "rel": rng.normal(size=(g.e_pad, TE.KGE_F)).astype(
                    np.float32)}
        deg = g.degrees()
        before = TK.LAUNCHES["gspmm"]
        out[d] = {
            "gcn_layer": TE.engine_gcn_layer(eng, deg, inputs["x"],
                                             inputs["w"]),
            "kge_score": TE.engine_kge_score(eng, inputs["ent"],
                                             inputs["rel"]),
            "wsssp": TE.engine_weighted_sssp(eng, 0),
            "bfs": TE.engine_bfs(eng, 0),
            "labelprop": TE.engine_label_propagation(eng, inputs["labels"]),
            "ppr": TE.engine_personalized_pagerank(eng, deg, inputs["p"])}
        launched = TK.LAUNCHES["gspmm"] - before
        assert launched == (2 if d == dev else 0)
    for name in ("wsssp", "bfs", "labelprop"):
        assert torch.equal(out[dev][name].state.cpu(), out["cpu"][name].state)
        assert out[dev][name].row() == out["cpu"][name].row()
    torch.testing.assert_close(out[dev]["ppr"].state.cpu(),
                               out["cpu"]["ppr"].state, rtol=1e-4, atol=0)
    for name in ("gcn_layer", "kge_score"):
        want = out["cpu"][name].state
        scale = float(want.abs().max())
        torch.testing.assert_close(out[dev][name].state.cpu(), want, rtol=0,
                                   atol=1e-4 * scale)


@pytest.mark.gpu
def test_lane_cumsum_matches_plain_on_card():
    """int32 exact, including S not a multiple of the tile, S = 1, K = 1
    and K wider than a block; float32 small integers exact (every partial
    sum is an integer below 2^24); random float32 in [0, 1) within 1e-4
    of the float64 running sum (float32 rounding over 7·10^4 terms, summed
    in another order). One launch per call."""
    from repro_torch.kernels import ops as TO
    dev = _card()
    rng = np.random.default_rng(3)
    for s, k in ((1, 16), (1, 1), (1024, 16), (1025, 16), (70_001, 16),
                 (4_097, 33), (300, 300), (5, 1)):
        x = torch.from_numpy(rng.integers(-5, 10, (s, k)).astype(np.int32))
        for xs in (x, x.float()):
            before = TO.LAUNCHES["lane_cumsum"]
            got = TO.lane_cumsum(xs.to(dev))
            torch.cuda.synchronize()
            assert TO.LAUNCHES["lane_cumsum"] == before + 1
            assert got.dtype == xs.dtype
            assert torch.equal(got.cpu(), TO.lane_cumsum(xs)), (s, k, xs.dtype)
    x = torch.from_numpy(rng.random((70_001, 16)).astype(np.float32))
    want = torch.cumsum(x.double(), 0)
    got = TO.lane_cumsum(x.to(dev)).cpu().double()
    assert float(((got - want).abs() / want.clamp(min=1.0)).max()) < 1e-4


@pytest.mark.gpu
def test_frontier_min_matches_plain_on_card():
    """Exact in float32 and bfloat16; a column with no member gives +inf;
    one launch per call."""
    from repro_torch.kernels import ops as TO
    dev = _card()
    gen = torch.Generator().manual_seed(4)
    for k, v in ((16, 5000), (7, 333), (1, 3)):
        state = torch.rand((k, v), generator=gen) * 100 - 20
        state = torch.where(torch.rand((k, v), generator=gen) < 0.1,
                            float("inf"), state)
        member = torch.rand((k, v), generator=gen) < 0.4
        member[:, 0] = False
        for dtype in (torch.float32, torch.bfloat16):
            st = state.to(dtype)
            before = TO.LAUNCHES["frontier_min"]
            got = TO.frontier_min(st.to(dev), member.to(dev))
            torch.cuda.synchronize()
            assert TO.LAUNCHES["frontier_min"] == before + 1
            assert got.dtype == dtype
            assert torch.equal(got.cpu(), TO.frontier_min(st, member))
            assert torch.isinf(got[0]).item()


def _cumsum_tile(k: int) -> int:
    """lane_cumsum's tile height for an aligned [S, k] array."""
    from repro_torch import cuda_build
    from repro_torch.kernels import ops as TO
    return cuda_build.query("lane_cumsum_tile_rows")(k, TO.cumsum_vec(k, 0,
                                                                      0))


@pytest.mark.gpu
@pytest.mark.parametrize("s,k,vec,rows,words", [
    # DFEP's [2·e_pad, 16] at dblp 1.0: 4 columns a load, 1,024-row tiles
    (1_902_592, 16, 4, 1024, 1 + 1858 * 16),
    (317_080, 16, 4, 1024, 1 + 310 * 16),
    # one column a load: 16 row groups
    (1_902_592, 16, 1, 256, 1 + 7432 * 16),
    (1, 16, 4, 1024, 1 + 16),
    (0, 16, 4, 1024, 1),
    (5, 1, 1, 4096, 1 + 1),
    (4096, 4, 4, 4096, 1 + 4),
    (4097, 33, 1, 112, 1 + 37 * 33),      # 7 row groups of 33 columns
    (300, 300, 4, 48, 1 + 7 * 300),       # 75 column vectors
    (300, 301, 1, 16, 1 + 19 * 301),      # wider than a block: 2 slabs
])
def test_lane_cumsum_layout_on_card(s, k, vec, rows, words):
    """The kernel's own tile height and scratch size (tile counter + a
    status word per row tile and column); -1 for a layout it refuses."""
    from repro_torch import cuda_build
    _card()
    assert cuda_build.query("lane_cumsum_tile_rows")(k, vec) == rows
    assert cuda_build.query("lane_cumsum_scratch_words")(s, k, vec) == words
    assert words == 1 + -(-s // rows) * k
    assert cuda_build.query("lane_cumsum_tile_rows")(k, 3) == -1
    assert cuda_build.query("lane_cumsum_scratch_words")(s, 0, vec) == -1


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 4, 16, 33, 300])
@pytest.mark.parametrize("where", ["tile-1", "tile", "tile+1", "two tiles"])
def test_lane_cumsum_tile_edges_on_card(k, where):
    """S at one tile, one tile ± 1 and exactly two tiles, int32 and float32
    small integers, exact; and the same on a view 4 bytes into its storage
    (one column a load)."""
    from repro_torch.kernels import ops as TO
    dev = _card()
    rows = _cumsum_tile(k)
    s = {"tile-1": rows - 1, "tile": rows, "tile+1": rows + 1,
         "two tiles": 2 * rows}[where]
    rng = np.random.default_rng(s * 7 + k)
    x = torch.from_numpy(rng.integers(-5, 10, (s, k)).astype(np.int32))
    for xs in (x, x.float()):
        got = TO.lane_cumsum(xs.to(dev))
        assert torch.equal(got.cpu(), TO.lane_cumsum(xs)), (s, k, xs.dtype)
        odd = torch.empty(s * k + 1, dtype=xs.dtype, device=dev)[1:]
        odd = odd.view(s, k)
        odd.copy_(xs)
        assert TO.cumsum_vec(k, odd.data_ptr(), 0) == 1
        assert torch.equal(TO.lane_cumsum(odd).cpu(), TO.lane_cumsum(xs))


@pytest.mark.gpu
def test_lane_cumsum_long_lookback_on_card():
    """2,000,000 × 16 rows: the look-back crosses ~2,000 tiles. int32
    exact, three calls in a row on the same input; float32 in [0, 1) within
    1e-4 of the float64 running sum (float32 rounding, another order)."""
    from repro_torch.kernels import ops as TO
    dev = _card()
    s, k = 2_000_000, 16
    assert -(-s // _cumsum_tile(k)) > 1000
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(-5, 10, (s, k)).astype(np.int32))
    want = TO.lane_cumsum(x)
    xd = x.to(dev)
    for _ in range(3):
        assert torch.equal(TO.lane_cumsum(xd).cpu(), want)
    xf = torch.from_numpy(rng.random((s, k)).astype(np.float32))
    wantf = torch.cumsum(xf.double(), 0)
    got = TO.lane_cumsum(xf.to(dev)).cpu().double()
    assert float(((got - wantf).abs() / wantf.clamp(min=1.0)).max()) < 1e-4


def _replays_equal(fn, static_in, inputs, plain) -> None:
    """Capture ``out = fn(static_in)`` in a CUDA graph, then for each of
    ``inputs``: copy it into ``static_in``, replay, and require ``out`` to
    equal ``plain`` of it (NaN where it has NaN). A fresh input each replay
    makes stale look-back flags from the replay before show."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(static_in)                       # build and load before capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(static_in)
    for x in inputs:
        static_in.copy_(x)
        graph.replay()
        torch.cuda.synchronize()
        _assert_same(out.cpu(), plain(x.cpu()))


def _assert_same(got: torch.Tensor, want: torch.Tensor) -> None:
    """Equal, NaN matching NaN."""
    nan = torch.isnan(want) if want.is_floating_point() else None
    if nan is None:
        assert torch.equal(got, want)
        return
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], want[~nan])


@pytest.mark.gpu
def test_lane_cumsum_graph_replays_on_card():
    """One call captured in a CUDA graph and replayed three times on three
    inputs: the static output equals the plain version after each replay
    (the tile counter and status words are zeroed inside the graph)."""
    from repro_torch.kernels import ops as TO
    dev = _card()
    rng = np.random.default_rng(6)
    xs = [torch.from_numpy(rng.integers(-5, 10, (70_001, 16))
                           .astype(np.int32)) for _ in range(3)]
    _replays_equal(TO.lane_cumsum, xs[0].to(dev).clone(), xs,
                   TO.lane_cumsum)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 16, 17, 40])
@pytest.mark.parametrize("v", [4096, 4097, 4099, 4100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frontier_min_widths_on_card(k, v, dtype):
    """V % 8 in {0, 1, 3, 4} (4 columns a thread in float32 and 8 in
    bfloat16, 1, 1, and 4), K = 1, 16, 17 and 40; +inf and NaN in member
    and non-member slots, a column with no member: exact against the plain
    version (NaN where it has NaN)."""
    from repro_torch.kernels import ops as TO
    dev = _card()
    tdt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(k * 10_000 + v)
    state = torch.rand((k, v), generator=gen) * 100 - 20
    state = torch.where(torch.rand((k, v), generator=gen) < 0.1,
                        float("inf"), state)
    member = torch.rand((k, v), generator=gen) < 0.2
    member[:, 0] = False                           # no member: +inf
    member[0, 1] = True
    state[0, 1] = float("nan")                     # member NaN: NaN
    member[:, 2] = False
    member[k - 1, 2] = True
    state[0, 2] = float("nan")                     # non-member NaN: ignored
    state[k - 1, 2] = 3.0
    st = state.to(tdt)
    sd, md = st.to(dev), member.to(dev)
    out_ptr = torch.empty(v, dtype=tdt, device=dev).data_ptr()
    assert TO.frontier_min_vec(v, st.element_size(), sd.data_ptr(),
                               md.data_ptr(), out_ptr) == \
        {0: 16 // st.element_size(), 1: 1, 3: 1, 4: 4}[v % 8]
    got = TO.frontier_min(sd, md).cpu()
    want = TO.frontier_min(st, member)
    _assert_same(got, want)
    assert torch.isinf(got[0]) and torch.isnan(got[1]) and got[2] == 3.0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frontier_min_misaligned_views_on_card(dtype):
    """A contiguous state view one element into its storage and a member
    view 3 bytes into its storage pass the wrapper's checks, run with one
    column a thread, and are exact."""
    from repro_torch.kernels import ops as TO
    dev = _card()
    tdt = getattr(torch, dtype)
    k, v = 16, 4096
    gen = torch.Generator().manual_seed(9)
    state = (torch.rand((k, v), generator=gen) * 50).to(tdt)
    member = torch.rand((k, v), generator=gen) < 0.2
    st = torch.empty(k * v + 1, dtype=tdt, device=dev)[1:].view(k, v)
    st.copy_(state)
    mb = torch.empty(k * v + 3, dtype=torch.bool, device=dev)[3:].view(k, v)
    mb.copy_(member)
    sd, md = state.to(dev), member.to(dev)
    want = TO.frontier_min(state, member)
    for s_arg, m_arg in ((st, md), (sd, mb), (st, mb)):
        widest = 16 // st.element_size()
        assert TO.frontier_min_vec(v, st.element_size(), s_arg.data_ptr(),
                                   m_arg.data_ptr(), 0) < widest
        _assert_same(TO.frontier_min(s_arg, m_arg).cpu(), want)


@pytest.mark.gpu
def test_frontier_min_graph_replays_on_card():
    """One call captured in a CUDA graph, replayed on three states: the
    static output equals the plain version after each replay."""
    from repro_torch.kernels import ops as TO
    dev = _card()
    gen = torch.Generator().manual_seed(10)
    k, v = 16, 50_000
    member = torch.rand((k, v), generator=gen) < 0.2
    md = member.to(dev)
    states = [torch.rand((k, v), generator=gen) * 30 for _ in range(3)]
    _replays_equal(lambda s: TO.frontier_min(s, md),
                   states[0].to(dev).clone(), states,
                   lambda s: TO.frontier_min(s, member))


@pytest.mark.gpu
def test_minplus_sweep_matches_plain_on_card():
    """Bit-identical to the plain version, with +inf and negative
    distances, masked, duplicate and self-target edges, at costs 1, 0, 0.5
    and -1 (where the self-loops count); one launch per call."""
    from repro_torch.kernels import ops as TO
    dev = _card()
    rng = np.random.default_rng(5)
    v, e = 2_000, 9_000
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    src[:500], dst[:500] = src[500:1000], dst[500:1000]
    dst[-20:] = src[-20:]
    mask = rng.random(e) < 0.9
    dist = np.where(rng.random(v) < 0.3, rng.random(v) * 10 - 3,
                    np.inf).astype(np.float32)
    args = [torch.from_numpy(a) for a in (dist, src, dst, mask)]
    for cost in (1.0, 0.0, 0.5, -1.0):
        before = TO.LAUNCHES["minplus_sweep"]
        got = TO.minplus_sweep(*[a.to(dev) for a in args], cost=cost)
        torch.cuda.synchronize()
        assert TO.LAUNCHES["minplus_sweep"] == before + 1
        assert torch.equal(got.cpu(), TO.minplus_sweep(*args, cost=cost))


def _minplus_graph(v: int, e: int, hub_edges: int, seed: int):
    """Random edges of ``v`` vertices with one hub (vertex 1) of
    ``hub_edges`` edges, a large row of 1,000 (vertex 2), a medium row of
    300 (vertex 3), duplicates, self-loops and padding slots (0, 0), ~10%
    masked; dist with +inf and negative values."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, v, e)
    dst = rng.integers(0, v, e)
    dst[:hub_edges] = 1
    src[hub_edges: hub_edges + 1000] = 2
    src[hub_edges + 1000: hub_edges + 1300] = 3
    src[-600:-400], dst[-600:-400] = src[:200], dst[:200]
    dst[-400:-200] = src[-400:-200]
    src[-200:] = dst[-200:] = 0
    mask = rng.random(e) < 0.9
    mask[-200:] = False
    dist = np.where(rng.random(v) < 0.3, rng.random(v) * 10 - 3, np.inf)
    return (dist.astype(np.float32), src.astype(np.int32),
            dst.astype(np.int32), mask)


def _minplus_shapes(seed: int):
    """(name, dist, src, dst, mask, layout maker) on the CPU at the three
    shapes: a whole graph's [V], ETSCH's flat [K·V] (K groups, hubs in
    every group) and the multi-source [K·S·V] under the flat layout with
    S replicas."""
    from repro_torch.kernels import ops as TO
    k, v, reps = 4, 3_000, 3    # the graph's odd V takes the scalar copy
    dist, src, dst, mask = _minplus_graph(v + 1, 40_000, 9_000, seed)
    parts = [_minplus_graph(v, 20_000, 5_000 + 500 * i, seed + 1 + i)
             for i in range(k)]
    fdist = np.concatenate([p[0] for p in parts])
    fsrc = np.concatenate([p[1] + i * v for i, p in enumerate(parts)])
    fdst = np.concatenate([p[2] + i * v for i, p in enumerate(parts)])
    fmask = np.concatenate([p[3] for p in parts])
    rng = np.random.default_rng(seed)
    mdist = np.where(rng.random(k * reps * v) < 0.3,
                     rng.random(k * reps * v) * 10, np.inf).astype(np.float32)
    t = torch.from_numpy
    return [
        ("graph", t(dist), t(src), t(dst), t(mask),
         lambda s, d: TO.minplus_layout(s, d, v + 1)),
        ("flat", t(fdist), t(fsrc), t(fdst), t(fmask),
         lambda s, d: TO.minplus_layout(s, d, k * v, groups=k)),
        ("multi", t(mdist), t(fsrc), t(fdst), t(fmask),
         lambda s, d: TO.minplus_layout(s, d, k * v, groups=k)
         .with_replicas(reps)),
    ]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["graph", "flat", "multi"])
def test_minplus_sweep_layouts_on_card(shape):
    """Bit-identical to the plain version at the three shapes, with hubs
    past MINPLUS_HUB (a cluster each), large and medium rows (a block and
    a warp each), padding and self-loops, at costs 1, 0, 0.5 and -1 (the
    prebuilt layout leaves the self-loops out, so -1 builds one with
    them), with a prebuilt layout and (one replica) without; one launch
    per call."""
    from repro_torch.kernels import ops as TO
    dev = _card()
    name, dist, src, dst, mask, make = next(
        c for c in _minplus_shapes(11) if c[0] == shape)
    cs, cd, cm, cdist = (a.to(dev) for a in (src, dst, mask, dist))
    lay = make(cs, cd)
    assert min(lay.counts) >= 1   # hubs, large and medium rows
    assert lay.loops_left_out > 0
    for cost in (1.0, 0.0, 0.5, -1.0):
        want = TO.minplus_sweep(dist, src, dst, mask, cost,
                                layout=make(src, dst))
        calls = [lambda: TO.minplus_sweep(cdist, cs, cd, cm, cost,
                                          layout=lay)]
        if lay.replicas == 1:
            calls.append(lambda: TO.minplus_sweep(cdist, cs, cd, cm, cost))
        for call in calls:
            before = TO.LAUNCHES["minplus_sweep"]
            got = call()
            torch.cuda.synchronize()
            assert TO.LAUNCHES["minplus_sweep"] == before + 1
            assert torch.equal(got.cpu(), want), (name, cost)


@pytest.mark.gpu
def test_minplus_sweep_graph_replays_on_card():
    """One sweep with the flat layout captured in a CUDA graph, replayed
    on three states: each output equals the plain version."""
    from repro_torch.kernels import ops as TO
    dev = _card()
    _, dist, src, dst, mask, make = _minplus_shapes(12)[1]
    cs, cd, cm = (a.to(dev) for a in (src, dst, mask))
    lay = make(cs, cd)
    gen = torch.Generator().manual_seed(4)
    states = [torch.where(torch.rand(dist.shape, generator=gen) < 0.3,
                          torch.rand(dist.shape, generator=gen) * 9,
                          float("inf")) for _ in range(3)]
    _replays_equal(lambda d: TO.minplus_sweep(d, cs, cd, cm, layout=lay),
                   states[0].to(dev).clone(), states,
                   lambda d: TO.minplus_sweep(d, src, dst, mask))


@pytest.mark.gpu
def test_dfep_and_etsch_on_card_equal_cpu():
    """DFEP on a small graph gives the CPU's owner and rounds now that its
    rank cumsum goes through lane_cumsum (launched on the card); ETSCH
    SSSP, CC (same ids), multi-source SSSP, k-core and MIS (same
    priorities) and the partition metrics equal the CPU's, through
    minplus_sweep and frontier_min."""
    from repro_torch.core import algorithms as TA
    from repro_torch.core import etsch as TEt
    from repro_torch.core import metrics as TM
    from repro_torch.kernels import ops as TO
    dev = _card()
    rng = np.random.default_rng(6)
    out, inputs = {}, None
    for d in (dev, "cpu"):
        g = TG.largest_component(TG.barabasi_albert(400, 3, seed=2,
                                                    device=d))
        before = dict(TO.LAUNCHES)
        owner, info = TD.partition(g, k=4, seed=0, max_rounds=400,
                                   stall_rounds=16, device=d)
        if inputs is None:
            n = g.n_vertices
            inputs = {"ids": rng.permutation(n),
                      "prio": rng.uniform(1e-6, 1.0, n).astype(np.float32),
                      "sources": np.array([0, 5, n - 1])}
        part = TEt.compile_partitioning(g, owner, 4, device=d)
        out[d] = {
            "owner": owner.cpu(), "rounds": info["rounds"],
            "sssp": TA.etsch_sssp(part, 0), "cc": TA.etsch_cc(
                part, ids=inputs["ids"]),
            "multi": TA.etsch_multi_sssp(part, inputs["sources"]),
            "kcore": TA.etsch_kcore(part, 3),
            "mis": TA.etsch_mis(part, prio=inputs["prio"]),
            "metrics": TM.evaluate(g, owner, 4, part=part).row(),
            "launches": {n: TO.LAUNCHES[n] - before[n] for n in TO.LAUNCHES}}
    assert torch.equal(out[dev]["owner"], out["cpu"]["owner"])
    assert out[dev]["rounds"] == out["cpu"]["rounds"]
    for name in ("sssp", "cc"):
        a, b = out[dev][name], out["cpu"][name]
        assert torch.equal(a.state.cpu(), b.state)
        assert (a.supersteps, a.local_iters) == (b.supersteps, b.local_iters)
    for name, field in (("multi", "dist"), ("kcore", "in_core"),
                        ("mis", "in_set")):
        a, b = out[dev][name], out["cpu"][name]
        assert torch.equal(getattr(a, field).cpu(), getattr(b, field))
        assert a.supersteps == b.supersteps
    assert out[dev]["metrics"] == out["cpu"]["metrics"]
    launched = out[dev]["launches"]
    assert min(launched[n] for n in ("lane_cumsum", "frontier_min",
                                     "minplus_sweep")) > 0, launched
    assert out["cpu"]["launches"] == {n: 0 for n in TO.LAUNCHES}


#: The scan kernel against its plain version, relative to the largest
#: |value|: both float32 and the same recurrence, but the kernel contracts
#: multiply-adds and sums the N-term dot in shuffle order (measured ~2e-7
#: on an H100).
SCAN_REL = 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,d,n", [(2, 100, 48, 8), (1, 70, 40, 32),
                                     (3, 33, 100, 4), (2, 1, 64, 16),
                                     (1, 257, 300, 16), (2, 1, 40, 4),
                                     (2, 1, 36, 8), (3, 1, 50, 32),
                                     (4, 1, 8192, 16), (2, 16, 64, 16),
                                     (2, 17, 130, 16), (1, 2, 24, 8)])
def test_selective_scan_matches_plain_on_card(b, s, d, n):
    """y and h_last against the plain loop, with and without h0, ragged
    channel blocks and sequence chunks (S = 1 takes the decode kernel);
    one launch per call."""
    from repro_torch.kernels import ops as TO
    dev = _card()
    gen = torch.Generator().manual_seed(b * 1000 + s + n)
    x = torch.randn((b, s, d), generator=gen)
    dt = torch.nn.functional.softplus(torch.randn((b, s, d), generator=gen))
    bb, cc = (torch.randn((b, s, n), generator=gen) * 0.5 for _ in range(2))
    a = torch.exp(torch.randn((d, n), generator=gen) * 0.3)
    dsk = torch.randn(d, generator=gen)
    h0 = torch.randn((b, d, n), generator=gen)
    for init in (None, h0):
        args = (x, dt, bb, cc, a, dsk, init)
        before = TO.LAUNCHES["selective_scan"]
        y, h = TO.selective_scan(*(None if t is None else t.to(dev)
                                   for t in args))
        torch.cuda.synchronize()
        assert TO.LAUNCHES["selective_scan"] == before + 1
        want_y, want_h = TO.selective_scan(*args)
        for got, want in ((y, want_y), (h, want_h)):
            err = float((got.cpu() - want).abs().max())
            assert err <= SCAN_REL * float(want.abs().max()), err
    with pytest.raises(ValueError, match="state width"):
        TO.selective_scan(*(t.to(dev) for t in (
            x, dt, bb[..., :3], cc[..., :3], a[:, :3], dsk)))


@pytest.mark.gpu
@pytest.mark.parametrize("n,lanes", [(4, 1), (8, 1), (16, 1), (32, 2),
                                     (12, -1)])
def test_selective_scan_lanes_on_card(n, lanes):
    """The prefill kernel's lanes per channel for each state width: one
    wherever a thread can hold all N states (the fastest at N = 16 on an
    H100), two at N = 32; -1 for a width it does not take."""
    from repro_torch import cuda_build
    _card()
    assert cuda_build.query("selective_scan_lanes")(n) == lanes


@pytest.mark.gpu
def test_mamba_serving_on_card_matches_cpu():
    """The falcon-mamba SMOKE model with the same parameters on the card
    and on the CPU: prefill logits within a bound relative to the largest
    logit (cuBLAS and the CPU sum bf16 products in other orders, so a
    bf16 rounding may flip), and Engine.generate launching the scan kernel
    once per layer and step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as TO
    from repro_torch.models import lm as TL
    from repro_torch.serve import serve_step as TSS
    dev = _card()
    cfg = get_config("falcon-mamba-7b", smoke=True)
    params = TL.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    on_card = TL.params_from_reference(cfg, TL.params_to_numpy(params), dev)
    prompts = torch.randint(0, cfg.vocab, (3, 9),
                            generator=torch.Generator().manual_seed(1))
    want, _, _ = TL.forward_lm(cfg, params, prompts)
    got, _, _ = TL.forward_lm(cfg, on_card, prompts.to(dev))
    err = float((got.cpu().float() - want.float()).abs().max())
    assert err <= 2e-2 * float(want.float().abs().max()), err
    before = TO.LAUNCHES["selective_scan"]
    toks = TSS.Engine(cfg, on_card, s_max=32).generate(prompts.to(dev), 5)
    assert toks.shape == (3, 5) and toks.device.type == "cuda"
    assert TO.LAUNCHES["selective_scan"] - before == 5 * cfg.n_layers


# ---------------------------------------------------------------------------
# the serving path: lanes on the kernels' feature axis
# ---------------------------------------------------------------------------

LANE_WIDTHS = (8, 32)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", LANE_WIDTHS)
def test_lane_widths_match_plain_on_card(lanes):
    """segment_reduce and exchange (min) at the serving path's lane widths
    ([K, Emax, S] messages, [K, Vmax, S] states) equal their plain
    versions bit for bit, one launch per call, on the fresh, patched and
    hub plans."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(lanes)
    plans = dict(_plans(dev), hub=_hub_plan(dev))
    for name, plan in plans.items():
        for rows, fn, ref in (
                (plan.e_max, TK.segment_reduce, TK.segment_reduce_ref),
                (plan.v_max, TK.exchange, TK.exchange_ref)):
            shape = (plan.k, rows, lanes)
            x = torch.where(torch.rand(shape, generator=gen, device=dev)
                            < 0.2, float("inf"),
                            torch.rand(shape, generator=gen, device=dev) * 30)
            before = dict(TK.LAUNCHES)
            got = fn(plan, x, "min")
            want = ref(plan, x, "min")
            torch.cuda.synchronize()
            assert sum(TK.LAUNCHES.values()) == sum(before.values()) + 1
            assert torch.equal(got, want), (name, fn.__name__)


@pytest.mark.gpu
def test_run_batched_on_card_equals_solo():
    """Batched sssp, bfs and wsssp on the card: every lane equals its solo
    run on the card (state bit for bit, equal counters), under a
    superstep cap, a local cap and a warm block with +inf rows; one
    exchange launch a superstep of the batch."""
    dev = _card()
    plan = _plans(dev)["fresh"]
    eng = TE.Engine(plan)
    src = np.array([0, 5, 17, 5, 120, 250, 3, 77], np.int32)
    for prog in (TE.SSSP, TE.BFS, TE.WEIGHTED_SSSP):
        for caps in ({}, {"max_supersteps": 2}, {"max_local_iters": 1}):
            before = TK.LAUNCHES["exchange"]
            r = eng.run_batched(prog, {"source": src}, **caps)
            assert TK.LAUNCHES["exchange"] - before == int(r.supersteps.max())
            for i, s in enumerate(src):
                one = eng.run(prog, source=int(s), **caps)
                assert torch.equal(r.state[i], one.state), (prog.name, caps)
                assert (int(r.supersteps[i]), int(r.local_iters[i]),
                        bool(r.converged[i])) == (
                    one.supersteps, one.local_iters, one.converged)
        block = eng.run_batched(prog, {"source": src},
                                max_supersteps=1).state.clone()
        block[[1, 4]] = float("inf")
        w = eng.run_batched(prog, {"source": src}, warm_state=block)
        for i, s in enumerate(src):
            one = eng.run(prog, source=int(s), warm_state=block[i])
            assert torch.equal(w.state[i], one.state), (prog.name, i)
            assert int(w.supersteps[i]) == one.supersteps

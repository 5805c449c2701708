"""repro_torch.stream against repro.stream on the CPU: the same seeded
inputs through both packages give the same slots, owners, plans and
answers.

``apply_edge_updates`` writes the same arrays; region DFEP sells the same
edges in the same rounds; ``StreamingGraph`` hands out the same slots and
epochs; ``hdrf_assign`` places every edge alike; ``patch_plan`` gives the
reference's patched plan field for field, equals a recompile of the same
content, leaves its input (and a cached plan) untouched and builds the
same kernel layouts as a fresh build, and raises ``SlackExhausted``
exactly when a target partition's slack overflows. One seeded update
stream through both ``StreamSession``s keeps owners, epochs, versions,
counters and the replication factor equal after every batch, with
SSSP/WCC/BFS bit-identical and PageRank/PPR within 1e-5."""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import engine as E
from repro import stream as RS
from repro.core import dfep as RD
from repro.core import graph as RG
from repro_torch import engine as TE
from repro_torch import stream as TS
from repro_torch.core import algorithms as TA
from repro_torch.core import dfep as TD
from repro_torch.core import graph as TG
from repro_torch.engine import kernels as TK
from repro_torch.engine.plan import (STATIC_FIELDS, TENSOR_FIELDS,
                                     build_layouts)

CPU = "cpu"
ADD_ATOL = 1e-5


def ref_starts(n_vertices: int, k: int, key: int = 0) -> np.ndarray:
    """The start vertices the reference's ``dfep.partition(key=key)``
    draws."""
    return np.asarray(jax.random.choice(jax.random.key(key), n_vertices,
                                        shape=(k,), replace=False))


def _pair(g, k, seed_key=0, **cfg):
    """The same session in both packages, from the same DFEP starts."""
    ref = RS.StreamSession(g, RS.StreamConfig(k=k, **cfg), key=seed_key)
    port = TS.StreamSession(TG.graph_from_numpy(g, device=CPU),
                            TS.StreamConfig(k=k, **cfg),
                            starts=ref_starts(g.n_vertices, k, seed_key),
                            device=CPU)
    return ref, port


def assert_plans_equal(want, got):
    """A reference plan and a port plan, field for field (values and
    dtypes)."""
    for f in STATIC_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    for f in TENSOR_FIELDS:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)


def assert_sessions_equal(ref, port):
    np.testing.assert_array_equal(port.owner, ref.owner)
    for name in ("epoch", "version", "n_ingested", "n_patches",
                 "n_recompiles", "n_forced_recompiles", "n_idle_compactions",
                 "n_reauctions"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.last_change == ref.last_change
    np.testing.assert_array_equal(port.touched, ref.touched)
    assert port.replication_factor() == ref.replication_factor()
    assert port.rf_base == ref.rf_base
    assert port.sg.epoch == ref.sg.epoch
    assert_plans_equal(ref.plan, port.plan)


def assert_answers_equal(ref, port):
    """Min programs bit-identical and counters equal, add programs within
    ADD_ATOL, port engine against the reference engine on each session's
    plan; and the port against its own oracles on ``port.graph()``."""
    g = port.graph()
    rg = ref.graph()
    for run_ref, run_port in (
            (lambda e: E.engine_sssp(e, 0), lambda e: TE.engine_sssp(e, 0)),
            (E.engine_wcc, TE.engine_wcc),
            (lambda e: E.engine_bfs(e, 1), lambda e: TE.engine_bfs(e, 1))):
        a, b = run_ref(ref.engine), run_port(port.engine)
        np.testing.assert_array_equal(b.state.numpy(), np.asarray(a.state))
        assert (b.supersteps, b.local_iters) == (int(a.supersteps),
                                                 int(a.local_iters))
    a = E.engine_pagerank(ref.engine, rg.degrees(), iters=15)
    b = TE.engine_pagerank(port.engine, g.degrees(), iters=15)
    np.testing.assert_allclose(b.state.numpy(), np.asarray(a.state), rtol=0,
                               atol=ADD_ATOL)
    pers = np.random.default_rng(5).random(g.n_vertices).astype(np.float32)
    pers /= pers.sum()
    a = E.engine_personalized_pagerank(ref.engine, rg.degrees(),
                                       jnp.asarray(pers), iters=10)
    b = TE.engine_personalized_pagerank(port.engine, g.degrees(), pers,
                                        iters=10)
    np.testing.assert_allclose(b.state.numpy(), np.asarray(a.state), rtol=0,
                               atol=ADD_ATOL)
    assert torch.equal(TE.engine_sssp(port.engine, 0).state,
                       TA.reference_sssp(g, 0)[0])
    assert torch.equal(TE.engine_wcc(port.engine).state,
                       TA.reference_cc(g)[0])


def _mutation(g, frac_del=0.07, frac_ins=0.08, seed=0):
    """>= 10% of |E| worth of deletions + insertions (tests/test_stream)."""
    rng = np.random.default_rng(seed)
    u, v = g.as_numpy()
    n_del = int(frac_del * g.n_edges)
    idx = rng.choice(g.n_edges, size=n_del, replace=False)
    dels = np.stack([u[idx], v[idx]], 1)
    ins = rng.integers(0, g.n_vertices, size=(int(frac_ins * g.n_edges), 2))
    return ins, dels


# ---------------------------------------------------------------------------
# graph.apply_edge_updates
# ---------------------------------------------------------------------------

def test_apply_edge_updates_matches_reference():
    g = RG.watts_strogatz(120, 4, 0.2, seed=3)
    rng = np.random.default_rng(0)
    slots = rng.choice(g.e_pad, size=40, replace=False)
    src = rng.integers(0, 120, 40)
    dst = rng.integers(0, 120, 40)
    mask = rng.random(40) < 0.6
    want = RG.apply_edge_updates(g, slots, src, dst, mask)
    tg = TG.graph_from_numpy(g, device=CPU)
    before = [t.clone() for t in (tg.src, tg.dst, tg.edge_mask)]
    got = TG.apply_edge_updates(tg, slots, src, dst, mask)
    assert got.n_edges == want.n_edges and got.n_vertices == want.n_vertices
    for f in ("src", "dst", "edge_mask"):
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    # functional: the input graph is untouched
    for old, t in zip(before, (tg.src, tg.dst, tg.edge_mask)):
        assert torch.equal(old, t)


# ---------------------------------------------------------------------------
# region DFEP
# ---------------------------------------------------------------------------

REGION_CASES = [("smallworld", 4, 1, 5), ("smallworld", 3, 0, 40),
                ("powerlaw", 4, 2, 20), ("powerlaw", 2, 1, 3)]


@pytest.fixture(scope="module")
def region_graphs():
    out = {}
    for name, ref in (("smallworld", RG.watts_strogatz(300, 6, 0.1, seed=2)),
                      ("powerlaw", RG.largest_component(
                          RG.barabasi_albert(200, 3, seed=4)))):
        out[name] = (ref, TG.graph_from_numpy(ref, device=CPU))
    return out


def _region_inputs(g, k, hops, n_touched):
    """A DFEP owner (reference, key 0) and the h-hop region around
    ``n_touched`` seeded vertices, as the session builds them."""
    owner, _ = RD.partition(g, k=k, key=0)
    owner = np.asarray(owner)
    touched = np.zeros(g.n_vertices, bool)
    touched[np.random.default_rng(k).choice(g.n_vertices, n_touched,
                                            replace=False)] = True
    u, v, m = (np.asarray(a) for a in (g.src, g.dst, g.edge_mask))
    region = RS.h_hop_vertices(u, v, m, g.n_vertices, touched, hops)
    return owner, touched, region, m & region[u] & region[v]


@pytest.mark.parametrize("case", REGION_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_run_dfep_region_identical(region_graphs, case):
    """init_region_state and run_dfep_region: owner, funding, rounds and
    stall count identical for the same owner, active set and region."""
    name, k, hops, n_touched = case
    ref, port = region_graphs[name]
    owner, _, region, active = _region_inputs(ref, k, hops, n_touched)
    assert 0 < active.sum() < np.asarray(ref.edge_mask).sum() or hops == 2
    cfg_r = RD.DfepConfig(k=k, max_rounds=400, stall_rounds=32)
    cfg_t = TD.DfepConfig(k=k, max_rounds=400, stall_rounds=32)
    args_r = (jnp.asarray(owner), jnp.asarray(active), jnp.asarray(region))
    args_t = tuple(torch.from_numpy(np.array(a))
                   for a in (owner, active, region))
    init_r = RD.init_region_state(ref, cfg_r, *args_r)
    init_t = TD.init_region_state(port, cfg_t, *args_t)
    np.testing.assert_array_equal(init_t.owner.numpy(),
                                  np.asarray(init_r.owner))
    np.testing.assert_array_equal(init_t.mv.numpy(), np.asarray(init_r.mv))
    want = RD.run_dfep_region(ref, RD.build_slots(ref), cfg_r, *args_r)
    got = TD.run_dfep_region(port, TD.build_slots(port), cfg_t, *args_t)
    np.testing.assert_array_equal(got.owner.numpy(), np.asarray(want.owner))
    np.testing.assert_array_equal(got.mv.numpy(), np.asarray(want.mv))
    assert int(got.rounds) == int(want.rounds) > 0
    assert int(got.stalled) == int(want.stalled)
    # only active edges change hands
    changed = got.owner.numpy() != owner
    assert not (changed & ~active).any()


def test_region_round_without_region_is_the_full_round(region_graphs):
    """``_round`` with ``active`` all real edges and ``grant_v`` all
    vertices equals the full-graph round (both None)."""
    ref, port = region_graphs["powerlaw"]
    cfg = TD.DfepConfig(k=4)
    slots = TD.build_slots(port)
    st = TD.init_state(port, cfg, ref_starts(port.n_vertices, 4))
    everything = torch.ones(port.n_vertices, dtype=torch.bool)
    for _ in range(5):
        a = TD._round(port, slots, cfg, st)
        b = TD._round(port, slots, cfg, st, active=port.edge_mask,
                      grant_v=everything)
        assert torch.equal(a.owner, b.owner) and torch.equal(a.mv, b.mv)
        st = a


@pytest.mark.parametrize("hops", [0, 1])
def test_local_reauction_matches_reference(region_graphs, hops):
    ref, port = region_graphs["powerlaw"]
    owner, touched, _, _ = _region_inputs(ref, 4, hops, 12)
    want, info_r = RS.local_reauction(ref, owner, touched, 4, hops=hops)
    got, info_t = TS.local_reauction(port, owner, touched, 4, hops=hops)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    region_s = info_t.pop("region_s")     # the port's timing of the rounds
    assert isinstance(region_s, float) and region_s >= 0.0
    assert info_t == info_r


def test_reauction_only_moves_region_edges():
    g = RG.watts_strogatz(200, 4, 0.1, seed=5)
    tg = TG.graph_from_numpy(g, device=CPU)
    owner, _ = TD.partition(tg, k=4, starts=ref_starts(200, 4), device=CPU)
    owner = owner.numpy()
    touched = np.zeros(g.n_vertices, bool)
    touched[:20] = True
    new_owner, info = TS.local_reauction(tg, owner, touched, 4, hops=1)
    u, v = np.asarray(g.src), np.asarray(g.dst)
    m = np.asarray(g.edge_mask)
    region = TS.h_hop_vertices(u, v, m, g.n_vertices, touched, 1)
    changed = (new_owner != owner) & m
    assert changed.any()
    assert not np.any(changed & ~(region[u] & region[v])), \
        "re-auction moved an edge outside the h-hop region"
    assert info["active_edges"] >= int(changed.sum())
    assert new_owner[m].min() >= 0 and new_owner[m].max() < 4
    assert (new_owner[~m] == -2).all()


# ---------------------------------------------------------------------------
# ingest and assignment
# ---------------------------------------------------------------------------

def _chunks(g, seed):
    """A seeded mix of delete and insert chunks: live edges, repeats,
    reversed pairs, self-loops and absent edges."""
    rng = np.random.default_rng(seed)
    u, v = g.as_numpy()
    out = []
    for i in range(6):
        if i % 2:
            idx = rng.choice(len(u), 10)
            out.append(("delete", np.concatenate(
                [np.stack([v[idx], u[idx]], 1),
                 rng.integers(0, g.n_vertices, (4, 2))])))
        else:
            e = rng.integers(0, g.n_vertices, (12, 2))
            out.append(("insert", np.concatenate([e, e[:2], [[5, 5]]])))
    return out


def test_streaming_graph_slots_and_epochs_match_reference():
    g = RG.watts_strogatz(120, 4, 0.2, seed=3)
    ref = RS.StreamingGraph(g, chunk_size=16)
    port = TS.StreamingGraph(TG.graph_from_numpy(g, device=CPU),
                             chunk_size=16)
    for step, (kind, edges) in enumerate(_chunks(g, 0)):
        a = getattr(ref, f"{kind}_chunk")(edges)
        b = getattr(port, f"{kind}_chunk")(edges)
        for f in ("slots", "u", "v"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(y, x)
        assert (port.n_edges, port.free_slots(), port.e_pad) == \
            (ref.n_edges, ref.free_slots(), ref.e_pad)
        if step == 3:
            np.testing.assert_array_equal(port.compact(0.25),
                                          ref.compact(0.25))
            assert port.epoch == ref.epoch == 1
        rg, tg = ref.graph(), port.graph()
        assert tg.n_edges == rg.n_edges and tg.e_pad == rg.e_pad
        for f in ("src", "dst", "edge_mask"):
            np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                          np.asarray(getattr(rg, f)))
        assert tg.fingerprint() == rg.fingerprint()
    with pytest.raises(ValueError):
        port.insert_chunk(np.zeros((17, 2)) + [[1, 2]])
    with pytest.raises(ValueError):
        port.insert_chunk(np.array([[0, g.n_vertices]]))


def test_streaming_graph_roundtrip():
    g = TG.watts_strogatz(120, 4, 0.2, seed=3, device=CPU)
    sg = TS.StreamingGraph(g, chunk_size=16)
    u, v = g.as_numpy()
    sg.delete_chunk(np.stack([u[:10], v[:10]], 1))
    new = np.array([[1, 99], [99, 1], [5, 5], [2, 117], [1, 99]])
    res = sg.insert_chunk(new)
    assert len(res.slots) == 2          # dedup + self-loop drop
    want = {(int(a), int(b)) for a, b in zip(u[10:], v[10:])}
    want |= {(1, 99), (2, 117)}
    want -= {(int(a), int(b)) for a, b in zip(u[:10], v[:10])}
    gu, gv = sg.graph().as_numpy()
    assert {(int(a), int(b)) for a, b in zip(gu, gv)} == want
    ref = TG.from_edge_array(g.n_vertices, np.array(sorted(want)),
                             device=CPU)
    assert sg.graph().fingerprint() == ref.fingerprint()
    fp = sg.graph().fingerprint()
    keep = sg.compact()
    assert sg.epoch == 1 and len(keep) == len(want)
    assert sg.graph().fingerprint() == fp
    assert sg.free_slots() >= sg.chunk_size
    lu, lv, live = sg.live_edges()
    assert (lu, lv) and np.array_equal(np.stack([lu, lv]),
                                       np.stack(sg.graph().as_numpy()))
    assert np.array_equal(live, sg.graph().edge_mask.numpy())


def test_hdrf_assign_matches_reference():
    g = RG.barabasi_albert(300, 3, seed=1)
    owner, _ = RD.partition(g, k=4, key=0)
    owner = np.asarray(owner)
    u, v = g.as_numpy()
    own = owner[np.asarray(g.edge_mask)]
    rng = np.random.default_rng(2)
    states = [RS.seed_state(u, v, own, g.n_vertices, 4),
              TS.seed_state(u, v, own, g.n_vertices, 4)]
    for a, b in zip(*states):
        np.testing.assert_array_equal(b, a)
    for _ in range(3):
        e = rng.integers(0, g.n_vertices, (64, 2))
        eu, ev = np.minimum(e[:, 0], e[:, 1]), np.maximum(e[:, 0], e[:, 1])
        want = RS.hdrf_assign(eu, ev, *states[0], lam=1.1)
        got = TS.hdrf_assign(eu, ev, *states[1], lam=1.1)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        for a, b in zip(*states):
            np.testing.assert_array_equal(b, a)


# ---------------------------------------------------------------------------
# patch_plan
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def patch_base():
    """A slack plan in both packages, its graph and DFEP owner."""
    g = RG.barabasi_albert(160, 3, seed=7)
    owner, _ = RD.partition(g, k=4, key=0)
    owner = np.asarray(owner)
    plan = E.compile_plan(g, owner, 4, edge_slack=24, vertex_slack=12)
    return g, owner, plan, TE.plan_from_numpy(plan, device=CPU)


def _changes(g, owner, kind, seed):
    """Seeded EdgeChange lists: deletes, inserts (new pairs, arrivals),
    re-auction moves, a mix, and raw inserts without graph slots."""
    rng = np.random.default_rng(seed)
    u, v = np.asarray(g.src), np.asarray(g.dst)
    live = np.flatnonzero(np.asarray(g.edge_mask))
    present = set(zip(u[live].tolist(), v[live].tolist()))
    out = []
    if kind in ("delete", "mix"):
        for s in rng.choice(live, 12, replace=False).tolist():
            out.append(RS.EdgeChange(int(u[s]), int(v[s]), int(owner[s]),
                                     -1, s))
    if kind in ("move", "mix"):
        for s in rng.choice(live, 8, replace=False).tolist():
            if any(c.slot == s for c in out):
                continue
            new = (int(owner[s]) + 1 + int(rng.integers(3))) % 4
            out.append(RS.EdgeChange(int(u[s]), int(v[s]), int(owner[s]),
                                     new, s))
    if kind in ("insert", "mix", "raw"):
        slot = g.e_pad
        while sum(c.old < 0 for c in out) < 15:
            a, b = sorted(rng.integers(0, g.n_vertices, 2).tolist())
            if a != b and (a, b) not in present:
                present.add((a, b))
                out.append(RS.EdgeChange(
                    b, a, -1, int(rng.integers(4)),
                    -1 if kind == "raw" else slot))
                slot += 1
    return out


@pytest.mark.parametrize("kind", ["delete", "insert", "move", "mix", "raw"])
def test_patch_plan_matches_reference(patch_base, kind):
    g, owner, plan, tplan = patch_base
    changes = _changes(g, owner, kind, seed=len(kind))
    want = RS.patch_plan(plan, changes)
    got = TS.patch_plan(tplan, changes)
    assert got is not tplan
    assert_plans_equal(want, got)
    # fields a patch leaves as they were are shared, not copied
    assert got.csr_fill is tplan.csr_fill
    if kind == "delete":
        assert got.edge_tgt is tplan.edge_tgt and got.edge_w is tplan.edge_w
    # a second patch on top of the first (freed slack reused, arrivals)
    more = _changes(g, owner, "insert", seed=99)
    assert_plans_equal(RS.patch_plan(want, more), TS.patch_plan(got, more))
    assert TS.patch_plan(tplan, []) is tplan


def test_patch_plan_raises_like_reference(patch_base):
    g, owner, plan, tplan = patch_base
    u, v = np.asarray(g.src), np.asarray(g.dst)
    s = int(np.flatnonzero(np.asarray(g.edge_mask))[0])
    wrong = (int(owner[s]) + 1) % 4
    for bad in ([RS.EdgeChange(int(u[s]), int(v[s]), wrong, -1)],
                [RS.EdgeChange(int(u[s]), int(v[s]), int(owner[s]), -1)] * 2):
        with pytest.raises(KeyError):
            RS.patch_plan(plan, bad)
        with pytest.raises(KeyError):
            TS.patch_plan(tplan, bad)


@pytest.mark.parametrize("target", [0, 2])
def test_slack_exhausted_on_the_target_partition(patch_base, target):
    """A batch of inserts into one partition fits while its own free CSR
    slots ``e_max - 1 - csr_fill[target]`` hold two half-edges each, and
    raises SlackExhausted one edge later, leaving the input plan as it
    was; the reference raises at the same count. (The reference's own
    ``test_patch_exhaustion_raises_and_leaves_plan_usable`` counts the
    free slots of the fullest partition instead and then fills another.)
    """
    g, owner, plan, tplan = patch_base
    free = plan.e_max - 1 - int(np.asarray(plan.csr_fill)[target])
    n_fit = free // 2
    # new pairs of vertices the partition already holds: only CSR slack
    held = np.asarray(plan.local2global)[target][
        np.asarray(plan.vmask)[target]]
    u, v = g.as_numpy()
    present = set(zip(u.tolist(), v.tolist()))
    pairs = [(a, b) for a, b in itertools.combinations(sorted(held.tolist()),
                                                       2)
             if (a, b) not in present][:n_fit + 1]
    assert len(pairs) == n_fit + 1
    fits = [RS.EdgeChange(a, b, -1, target) for a, b in pairs[:n_fit]]
    over = [RS.EdgeChange(a, b, -1, target) for a, b in pairs]
    snapshot = {f: getattr(tplan, f).clone() for f in TENSOR_FIELDS}
    assert_plans_equal(RS.patch_plan(plan, fits), TS.patch_plan(tplan, fits))
    with pytest.raises(RS.SlackExhausted):
        RS.patch_plan(plan, over)
    with pytest.raises(TS.SlackExhausted, match=f"partition {target}"):
        TS.patch_plan(tplan, over)
    for f, t in snapshot.items():
        assert torch.equal(getattr(tplan, f), t), f


def test_vertex_slack_exhausted():
    """Inserts that bring one more new vertex into a partition than it has
    free vertex slots raise, in both packages; one fewer fits."""
    from repro.core import baselines as RB
    g = RG.barabasi_albert(1000, 3, seed=2)
    plan = E.compile_plan(g, RB.hash_partition(g, 4), 4, edge_slack=100)
    tplan = TE.plan_from_numpy(plan, device=CPU)
    vmask = np.asarray(plan.vmask)
    p = int(np.argmax(vmask.sum(1)))
    held = set(np.asarray(plan.local2global)[p][vmask[p]].tolist())
    outside = [x for x in range(g.n_vertices) if x not in held]
    free_v = plan.v_max - int(vmask[p].sum())
    assert len(outside) > free_v + 2 and free_v < 128
    arrivals = outside[:free_v + 1]
    edges = list(zip(arrivals[0::2], arrivals[1::2]))
    if len(arrivals) % 2:        # the odd one out joins a held vertex
        edges.append((arrivals[-1], min(held)))
    fits = [RS.EdgeChange(a, b, -1, p) for a, b in edges[:-1]]
    over = [RS.EdgeChange(a, b, -1, p) for a, b in edges]
    assert_plans_equal(RS.patch_plan(plan, fits), TS.patch_plan(tplan, fits))
    with pytest.raises(RS.SlackExhausted):
        RS.patch_plan(plan, over)
    with pytest.raises(TS.SlackExhausted, match="vertex slack"):
        TS.patch_plan(tplan, over)


def _slot_map(plan, field):
    l2g = plan.local2global.cpu().numpy()
    tgt = plan.edge_tgt.cpu().numpy()
    nbr = plan.edge_nbr.cpu().numpy()
    em = plan.emask.cpu().numpy()
    val = getattr(plan, field).cpu().numpy()
    return {(p, int(l2g[p, tgt[p, s]]), int(l2g[p, nbr[p, s]])):
            val[p, s].item() for p in range(plan.k)
            for s in np.flatnonzero(em[p])}


def test_patched_plan_equals_port_recompile():
    """The session's patched plan against a from-scratch ``compile_plan``
    of the same (graph, owner): counts, edge sets, per-half-edge graph
    slots and weights (tests/test_stream.py's check, on the port)."""
    g = TG.watts_strogatz(150, 4, 0.1, seed=1, device=CPU)
    sess = TS.StreamSession(g, TS.StreamConfig(k=4, chunk_size=32,
                                               drift_threshold=1e9),
                            starts=ref_starts(150, 4), device=CPU)
    ins, dels = _mutation(g, seed=1)
    sess.apply(inserts=ins, deletes=dels)
    assert sess.n_patches >= 1 and sess.n_recompiles == 0
    g2 = sess.graph()
    fresh = TE.compile_plan(g2, sess.owner, 4, device=CPU)
    assert fresh.exchange_volume == sess.plan.exchange_volume
    assert fresh.sum_local_vertices == sess.plan.sum_local_vertices
    assert fresh.replication_factor() == sess.plan.replication_factor()
    assert torch.equal(fresh.n_edges_local, sess.plan.n_edges_local)
    want = np.unique(np.stack(g2.as_numpy(), 1), axis=0)
    got = np.unique(np.concatenate(sess.plan.local_edges(), 0), axis=0)
    assert np.array_equal(want, got)
    for field in ("edge_slot", "edge_w"):
        assert _slot_map(sess.plan, field) == _slot_map(fresh, field)
    assert sess.plan.edge_slot_hwm == fresh.edge_slot_hwm
    for run in (lambda e: TE.engine_sssp(e, 3), TE.engine_wcc,
                lambda e: TE.engine_weighted_sssp(e, 3)):
        assert torch.equal(run(sess.engine).state,
                           run(TE.Engine(fresh)).state)


def _layout_tensors(lay):
    for f in dataclasses.fields(lay):
        x = getattr(lay, f.name)
        if dataclasses.is_dataclass(x):
            yield from _layout_tensors(x)
        else:
            yield f.name, x


def test_patched_layouts_equal_fresh_builds(patch_base):
    """A patched plan comes without kernel layouts; the three that
    ``build_layouts`` then gives it equal layouts built from scratch on a
    copy of its fields, and the input plan's memoized layouts are the
    ones it had."""
    g, owner, plan, _ = patch_base
    tplan = TE.plan_from_numpy(plan, device=CPU)
    before = {name: getattr(TK, name)(tplan) for name in
              ("segment_layout", "gspmm_layout", "exchange_layout")}
    got = TS.patch_plan(tplan, _changes(g, owner, "mix", seed=4))
    for name in ("segment_layout", "gspmm_layout", "exchange_layout"):
        assert f"_{name}" not in got.__dict__, f"{name} built by the patch"
    assert build_layouts(got) is got
    copy = TE.plan_from_numpy({f: getattr(got, f) if f in STATIC_FIELDS
                               else getattr(got, f).numpy()
                               for f in (*STATIC_FIELDS, *TENSOR_FIELDS)},
                              device=CPU)
    for name, build in (("segment_layout", TK.build_segment_layout),
                        ("gspmm_layout", TK.build_gspmm_layout),
                        ("exchange_layout", TK.build_exchange_layout)):
        assert f"_{name}" in got.__dict__, f"{name} not built"
        fresh = dict(_layout_tensors(build(copy)))
        for key, val in _layout_tensors(getattr(TK, name)(got)):
            if isinstance(val, torch.Tensor):
                assert torch.equal(val, fresh[key]), (name, key)
            else:
                assert val == fresh[key], (name, key)
        assert getattr(TK, name)(tplan) is before[name]
    stats = TK.segment_layout(got).stats()
    assert stats["append_slots"] > 0 and stats["longest_append_run"] >= 1


def test_patch_leaves_input_and_cached_plans_untouched():
    """A patch never writes into its input: a ``compile_plan_cached`` plan
    (shared by every caller of its key) keeps every field and memoized
    value, and still answers for the graph it was compiled from."""
    TE.plan_cache_clear()
    g = TG.watts_strogatz(140, 4, 0.1, seed=3, device=CPU)
    owner, _ = TD.partition(g, k=4, starts=ref_starts(140, 4), device=CPU)
    plan = TE.compile_plan_cached(g, owner, 4, edge_slack=16,
                                  vertex_slack=8, device=CPU)
    sssp_before = TE.engine_sssp(TE.Engine(plan), 0).state
    snapshot = {f: getattr(plan, f).clone() for f in TENSOR_FIELDS}
    memo = dict(plan.__dict__)
    u, v = g.as_numpy()
    own = owner.numpy()[g.edge_mask.numpy()]
    changes = [TS.EdgeChange(int(u[i]), int(v[i]), int(own[i]), -1, i)
               for i in range(0, 30, 3)]
    changes += [TS.EdgeChange(0, 70 + i, -1, i % 4, g.e_pad - 1 - i)
                for i in range(6)]
    new = build_layouts(TS.patch_plan(plan, changes))
    assert new is not plan
    for f, t in snapshot.items():
        assert torch.equal(getattr(plan, f), t), f
    for key, val in memo.items():
        assert plan.__dict__[key] is val, key
    # the only memo a patch adds to its input: read-only host copies
    assert all(key.startswith("_host_")
               for key in set(plan.__dict__) - set(memo))
    again = TE.compile_plan_cached(g, owner, 4, edge_slack=16,
                                   vertex_slack=8, device=CPU)
    assert again is plan
    assert torch.equal(TE.engine_sssp(TE.Engine(again), 0).state,
                       sssp_before)
    assert torch.equal(sssp_before, TA.reference_sssp(g, 0)[0])
    # the patched plan has the same shapes and none of the input's memo
    for f in STATIC_FIELDS:
        assert getattr(new, f) == getattr(plan, f)
    for f in TENSOR_FIELDS:
        assert getattr(new, f).shape == getattr(plan, f).shape
    for key, val in new.__dict__.items():
        if key.startswith("_"):
            assert val is not plan.__dict__.get(key), key


# ---------------------------------------------------------------------------
# StreamSession: one seeded update stream through both packages
# ---------------------------------------------------------------------------

SESSION_CASES = {
    # patches only
    "patch": dict(graph=("ws", 300, 6, 0.1, 2), k=4, chunk_size=64,
                  drift_threshold=1e9),
    # drift re-auctions (hops 1) patched in
    "reauction": dict(graph=("ws", 300, 6, 0.1, 5), k=4, chunk_size=64,
                      drift_threshold=0.02, hops=1),
    # small padding: compaction epochs and slack recompiles
    "compaction": dict(graph=("ws", 100, 4, 0.1, 1), k=3, chunk_size=32,
                       drift_threshold=1e9, edge_slack=4, vertex_slack=2),
}


def _graph(spec):
    kind, n, a, b, seed = spec
    return RG.watts_strogatz(n, a, b, seed=seed) if kind == "ws" \
        else RG.barabasi_albert(n, a, seed=seed)


@pytest.mark.parametrize("case", sorted(SESSION_CASES))
def test_session_stream_matches_reference(case):
    cfg = dict(SESSION_CASES[case])
    g = _graph(cfg.pop("graph"))
    ref, port = _pair(g, **cfg)
    assert_sessions_equal(ref, port)
    rng = np.random.default_rng(7)
    for batch in range(3):
        ins, dels = _mutation(ref.graph(), seed=batch)
        if case == "compaction":
            ins = rng.integers(0, g.n_vertices, size=(120, 2))
        want = ref.apply(inserts=ins, deletes=dels)
        got = port.apply(inserts=ins, deletes=dels)
        if got["reauction"] is not None:   # the port's timing of the rounds
            assert got["reauction"].pop("region_s") >= 0.0
        assert got == want
        assert_sessions_equal(ref, port)
        assert_answers_equal(ref, port)
    if case == "reauction":
        assert port.n_reauctions >= 1
    if case == "compaction":
        assert port.epoch >= 1 and port.n_recompiles >= 1
        assert port.plan.epoch == port.epoch


def test_incremental_rf_within_10pct_of_full_rerun():
    g = TG.watts_strogatz(300, 6, 0.1, seed=2, device=CPU)
    sess = TS.StreamSession(g, TS.StreamConfig(k=4, chunk_size=64,
                                               drift_threshold=0.02),
                            starts=ref_starts(300, 4), device=CPU)
    ins, dels = _mutation(g, seed=0)
    sess.apply(inserts=ins, deletes=dels)
    assert sess.n_reauctions >= 1
    g2 = sess.graph()
    assert torch.equal(TE.engine_sssp(sess.engine, 0).state,
                       TA.reference_sssp(g2, 0)[0])
    owner_full, _ = TD.partition(g2, k=4, starts=ref_starts(300, 4, key=1),
                                 device=CPU)
    rf_full = TE.compile_plan(g2, owner_full, 4,
                              device=CPU).replication_factor()
    assert sess.replication_factor() <= 1.10 * rf_full


def test_vertex_departure_and_return():
    """Deleting a vertex's last edge clears its slot; re-inserting later
    re-registers it (slot reuse); results stay exact throughout."""
    g = TG.watts_strogatz(80, 4, 0.1, seed=4, device=CPU)
    sess = TS.StreamSession(g, TS.StreamConfig(k=3, chunk_size=32,
                                               drift_threshold=1e9),
                            starts=ref_starts(80, 3), device=CPU)
    u, v = g.as_numpy()
    inc = (u == 0) | (v == 0)
    held = sess.plan.vmask & (sess.plan.local2global == 0)
    assert held.any()
    sess.apply(deletes=np.stack([u[inc], v[inc]], 1))
    assert not (sess.plan.vmask & (sess.plan.local2global == 0)).any()
    d = TE.engine_sssp(sess.engine, 0).state
    assert torch.equal(d, TA.reference_sssp(sess.graph(), 0)[0])
    assert d[0] == 0.0 and torch.isinf(d[1:]).all()
    sess.apply(inserts=np.array([[0, 40], [0, 41]]))
    d2 = TE.engine_sssp(sess.engine, 0).state
    assert torch.equal(d2, TA.reference_sssp(sess.graph(), 0)[0])
    assert d2[40] == 1.0 and d2[41] == 1.0
    assert torch.equal(TE.engine_wcc(sess.engine).state,
                       TA.reference_cc(sess.graph())[0])


def test_batched_serving_on_patched_plan():
    g = TG.watts_strogatz(120, 4, 0.2, seed=3, device=CPU)
    sess = TS.StreamSession(g, TS.StreamConfig(k=4, chunk_size=32,
                                               drift_threshold=1e9),
                            starts=ref_starts(120, 4), device=CPU)
    ins, dels = _mutation(g, seed=2)
    sess.apply(inserts=ins, deletes=dels)
    sources = [0, 7, 33, 64]
    res = TE.multi_source_sssp(sess.engine, sources)
    for i, s in enumerate(sources):
        assert torch.equal(res.state[i],
                           TA.reference_sssp(sess.graph(), s)[0])


def test_engine_rebinds_through_with_plan():
    """Every installed plan reaches the session's engine through
    ``Engine.with_plan``: the engine keeps its settings across patches,
    re-auctions and recompiles."""
    g = TG.watts_strogatz(100, 4, 0.1, seed=1, device=CPU)
    sess = TS.StreamSession(g, TS.StreamConfig(k=3, chunk_size=32,
                                               drift_threshold=1e9),
                            starts=ref_starts(100, 3), device=CPU)
    sess.engine = TE.Engine(sess.plan, use_kernels=False)
    events = []
    sess.subscribe(lambda s, event: events.append(
        (event, s.engine.plan is s.plan, s.engine.use_kernels)))
    sess.apply(inserts=np.array([[0, 50], [1, 60]]))
    rng = np.random.default_rng(1)
    sess.apply(inserts=rng.integers(0, 100, size=(400, 2)))
    assert ("patch", True, False) in events
    assert ("recompile", True, False) in events
    assert all(same and not kernels for _, same, kernels in events)


def test_session_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = TG.watts_strogatz(60, 4, 0.1, seed=1, device=CPU)
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.StreamSession(g, TS.StreamConfig(k=2),
                         owner=torch.zeros(g.e_pad, dtype=torch.int32))


def test_obs_events_match_reference():
    """With the recorder on, one apply records the reference's stream
    events with the same fields (plan swaps with their health gauges).
    The port adds only a ``stream.patch_plan`` span to each patch (and,
    on the card, a ``stream.layouts`` span) and ``region_s`` to the
    re-auction's event."""
    from repro import obs as robs
    from repro_torch import obs as tobs
    g = RG.watts_strogatz(120, 4, 0.2, seed=2)
    ref, port = _pair(g, 3, chunk_size=32, drift_threshold=0.01, hops=1)
    ins, dels = _mutation(g, seed=3)
    out = []
    for obs, sess in ((robs, ref), (tobs, port)):
        obs.reset()
        obs.enable()
        try:
            sess.apply(inserts=ins, deletes=dels)
            events = [e for e in obs.get().events()
                      if e["name"].startswith("stream.")]
            gauges = {k: v for k, v in obs.get().gauges().items()
                      if k.startswith("stream.")}
        finally:
            obs.disable()
            obs.reset()
        out.append(([(e["name"], {k: v for k, v in e["args"].items()
                                  if k not in ("span_id", "parent_id",
                                               "dur_us")})
                     for e in events], gauges))
    (ev_r, g_r), (ev_t, g_t) = out
    own = [a for n, a in ev_t if n == "stream.patch_plan"]
    patches = [a for n, a in ev_t
               if n == "stream.plan_swap" and a["event"] == "patch"]
    assert len(own) == len(patches) >= 2 and all(a["changes"] > 0
                                                 for a in own)
    ev_t = [(n, a) for n, a in ev_t if n != "stream.patch_plan"]
    assert [n for n, _ in ev_t] == [n for n, _ in ev_r]
    assert "stream.reauction" in [n for n, _ in ev_t]
    for (name, a), (_, b) in zip(ev_r, ev_t):
        if name == "stream.reauction":
            assert b.pop("region_s") >= 0.0
        assert b == a, name
    assert g_t == g_r

"""The second slice of the port against the JAX package: the channel
gathers, ``gspmm_ref`` against the Pallas ``gspmm`` (interpret mode), and
the programs wsssp, BFS, labelprop, PPR, ``gcn_layer`` and ``kge_score``
through the port's ``Engine``, on fresh, slack and ``patch_plan``-patched
plans. min programs and the gathers are bit-identical (equal superstep and
local-iteration counters); add results within 1e-5; ``kge_score`` within
1e-5 plus 2e-4 relative, since its hub sums are unnormalised degree-length
float32 sums (``repro.core.algorithms.reference_kge_score``). The CUDA
kernel runs only on a card: ``tests/test_torch_gpu.py`` holds it against
``gspmm_ref``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import engine as E
from repro.core import algorithms as alg
from repro.core import baselines
from repro.core import dfep as RD
from repro.core import graph as RG
from repro.engine import kernels as RK
from repro.stream.patch import EdgeChange, patch_plan
from repro_torch import engine as TE
from repro_torch.core import dfep as TD
from repro_torch.core import graph as TG
from repro_torch.engine import kernels as TK

CPU = "cpu"
ADD_ATOL = 1e-5
KGE_ATOL, KGE_RTOL = 1e-5, 2e-4
SOURCE = 3
PLANS = ("fresh", "slack", "patched")


def _patched(plan, g, owner, seed: int):
    """Delete a few live edges (holes in the CSR prefix) and insert new ones
    into the append region: a third without slot provenance (``edge_slot``
    -1), a third with a graph slot inside the edge plane and a third with a
    slot past its end."""
    rng = np.random.default_rng(seed)
    u, v = g.as_numpy()
    own = np.asarray(owner)[np.asarray(g.edge_mask)]
    dele = rng.choice(len(u), size=6, replace=False)
    changes = [EdgeChange(int(u[i]), int(v[i]), int(own[i]), -1)
               for i in dele]
    present = set(zip(u.tolist(), v.tolist()))
    n_new = 0
    while n_new < 12:
        a, b = sorted(rng.integers(0, g.n_vertices, 2).tolist())
        if a != b and (a, b) not in present:
            present.add((a, b))
            slot = (-1, int(rng.integers(0, g.e_pad)), g.e_pad + n_new)[
                n_new % 3]
            changes.append(EdgeChange(a, b, -1, int(rng.integers(0, plan.k)),
                                      slot))
            n_new += 1
    return patch_plan(plan, changes)


@pytest.fixture(scope="module")
def setup():
    """(reference graph, name -> reference plan)."""
    g = RG.largest_component(RG.barabasi_albert(120, 3, seed=2))
    owner = baselines.hash_partition(g, 4)
    slack = E.compile_plan(g, owner, 4, edge_slack=12, vertex_slack=8)
    patched = _patched(slack, g, owner, seed=0)
    em = np.asarray(patched.emask)
    eslot = np.asarray(patched.edge_slot)
    in_csr = np.arange(patched.e_max)[None, :] < np.asarray(
        patched.csr_fill)[:, None]
    assert (em & ~in_csr).any() and (~em & in_csr).any()
    assert (em & (eslot == -1)).any() and (em & (eslot >= g.e_pad)).any()
    return g, {"fresh": E.compile_plan(g, owner, 4), "slack": slack,
               "patched": patched}


def _port(plan):
    return TE.plan_from_numpy(plan, device=CPU)


# ---------------------------------------------------------------------------
# channel gathers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", PLANS)
def test_gather_vertex_channel_matches_reference(setup, name):
    g, plans = setup
    plan = plans[name]
    rng = np.random.default_rng(1)
    for shape in ((g.n_vertices,), (g.n_vertices, 3)):
        vals = rng.normal(size=shape).astype(np.float32)
        want = np.asarray(RK.gather_vertex_channel(plan, jnp.asarray(vals)))
        got = TK.gather_vertex_channel(_port(plan), torch.from_numpy(vals))
        assert got.dtype == torch.float32 and got.ndim == 3
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", PLANS)
def test_gather_edge_channel_matches_reference(setup, name):
    """Full and short planes (rows past the plane read ``fill``, never a
    clamped row), scalar and wide, two fill values."""
    g, plans = setup
    plan = plans[name]
    rng = np.random.default_rng(2)
    for rows in (g.e_pad, g.e_pad // 2):
        for shape in ((rows,), (rows, 3)):
            vals = rng.normal(size=shape).astype(np.float32)
            for fill in (0.0, 2.5):
                want = np.asarray(RK.gather_edge_channel(
                    plan, jnp.asarray(vals), fill=fill))
                got = TK.gather_edge_channel(_port(plan),
                                             torch.from_numpy(vals),
                                             fill=fill)
                assert got.dtype == torch.float32 and got.ndim == 3
                np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# gspmm
# ---------------------------------------------------------------------------

def _gspmm_inputs(g, plan, features: int, per_feature: bool, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(g.n_vertices, features)).astype(np.float32)
    feats = np.array(RK.gather_vertex_channel(plan, jnp.asarray(x)))
    if features == 1:
        feats = feats[:, :, 0]       # rank-2 feats come back rank 3
    if per_feature:
        w = rng.normal(size=plan.emask.shape + (features,)).astype(
            np.float32)
    else:
        w = np.array(plan.edge_w)
    return feats, w


@pytest.mark.parametrize("per_feature", [False, True],
                         ids=["scalar_w", "feature_w"])
@pytest.mark.parametrize("features", [1, 4, 8])
@pytest.mark.parametrize("name", PLANS)
def test_gspmm_ref_matches_reference(setup, name, features, per_feature):
    """max bit-identical, add/sum/mean within 1e-5 of the Pallas gspmm and
    of the reference's gspmm_ref; always rank 3."""
    g, plans = setup
    plan = plans[name]
    feats, w = _gspmm_inputs(g, plan, features, per_feature,
                             seed=features + 10 * per_feature)
    tplan = _port(plan)
    for combine in ("add", "sum", "max", "mean"):
        pallas = np.asarray(RK.gspmm(plan, jnp.asarray(feats),
                                     jnp.asarray(w), combine))
        xla = np.asarray(RK.gspmm_ref(plan, jnp.asarray(feats),
                                      jnp.asarray(w), combine))
        got = TK.gspmm_ref(tplan, torch.from_numpy(feats),
                           torch.from_numpy(w), combine)
        assert got.dtype == torch.float32
        assert got.shape == (plan.k, plan.v_max, features) == pallas.shape
        got = got.numpy()
        if combine == "max":
            np.testing.assert_array_equal(got, pallas)
            np.testing.assert_array_equal(got, xla)
        else:
            np.testing.assert_allclose(got, pallas, rtol=0, atol=ADD_ATOL)
            np.testing.assert_allclose(got, xla, rtol=0, atol=ADD_ATOL)


@pytest.mark.parametrize("name", PLANS)
def test_run_start_is_each_slots_run_start(setup, name):
    """``plan.run_start[k, s]`` is the nearest slot at or before s with
    ``seg_start`` set, 0 if none, for every slot of every partition."""
    _, plans = setup
    tplan = _port(plans[name])
    seg = tplan.seg_start.numpy()
    got = tplan.run_start
    assert got.dtype == torch.int32 and got.is_contiguous()
    want = np.zeros(seg.shape, np.int32)
    for k in range(tplan.k):
        start = 0
        for s in range(tplan.e_max):
            start = s if seg[k, s] else start
            want[k, s] = start
    np.testing.assert_array_equal(got.numpy(), want)


def _kernel_rule_aggregate(tplan, msgs: np.ndarray, combine: str):
    """The CUDA kernels' reading of a plan, in numpy: each live target
    combines its live slots in ``[run_start[last_slot], min(last_slot,
    csr_fill - 1)]``, then live append-region slots are combined into their
    target; identity where ``vmask`` is False."""
    ident = {"min": np.inf, "max": -np.inf, "add": 0.0}[combine]
    op = {"min": np.minimum, "max": np.maximum, "add": np.add}[combine]
    rs, last = tplan.run_start.numpy(), tplan.last_slot.numpy()
    em, vm = tplan.emask.numpy(), tplan.vmask.numpy()
    fill, tgt = tplan.csr_fill.numpy(), tplan.edge_tgt.numpy()
    out = np.full((tplan.k, tplan.v_max), ident, np.float32)
    for k in range(tplan.k):
        for v in range(tplan.v_max):
            hi = min(last[k, v], fill[k] - 1)
            if not vm[k, v] or hi < 0 or last[k, v] >= tplan.e_max:
                continue
            for s in range(rs[k, last[k, v]], hi + 1):
                if em[k, s]:
                    out[k, v] = op(out[k, v], msgs[k, s])
        for s in range(fill[k], tplan.e_max):
            if em[k, s] and vm[k, tgt[k, s]]:
                out[k, tgt[k, s]] = op(out[k, tgt[k, s]], msgs[k, s])
    return out


@pytest.mark.parametrize("name", PLANS)
def test_kernel_run_rule_matches_reference_scan(setup, name):
    """The run rule both CUDA kernels follow reproduces the Pallas
    segmented scan read at ``last_slot``: min and max bit-identical, add
    within 1e-5, on fresh, slack and patched plans."""
    _, plans = setup
    plan = plans[name]
    tplan = _port(plan)
    rng = np.random.default_rng(5)
    base = rng.random(plan.emask.shape).astype(np.float32)
    for combine in ("min", "max", "add"):
        msgs = np.where(rng.random(base.shape) < 0.2, np.float32(np.inf),
                        base * 10) if combine == "min" else base
        want = np.asarray(RK.segment_reduce(plan, jnp.asarray(msgs),
                                            combine))
        got = _kernel_rule_aggregate(tplan, msgs, combine)
        if combine == "add":
            np.testing.assert_allclose(got, want, rtol=0, atol=ADD_ATOL)
        else:
            np.testing.assert_array_equal(got, want)


def test_gspmm_dispatches_plain_on_cpu(setup):
    """A CPU tensor runs the plain version and launches nothing, for every
    combine (``mean`` counts the degree through ``segment_reduce``)."""
    g, plans = setup
    plan = _port(plans["patched"])
    feats, w = _gspmm_inputs(g, plans["patched"], 4, False, seed=3)
    feats, w = torch.from_numpy(feats), torch.from_numpy(w)
    before = dict(TK.LAUNCHES)
    for combine in ("add", "max", "mean"):
        got = TK.gspmm(plan, feats, w, combine)
        assert torch.equal(got, TK.gspmm_ref(plan, feats, w, combine))
    assert TK.LAUNCHES == before


def test_gspmm_refuses_other_devices(setup):
    plan = _port(setup[1]["fresh"])
    meta = torch.empty((plan.k, plan.v_max, 2), device="meta")
    with pytest.raises(ValueError):
        TK.gspmm(plan, meta, plan.edge_w, "add")


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------

def _row(r) -> dict:
    return {"supersteps": int(r.supersteps), "local_iters": int(r.local_iters),
            "converged": bool(r.converged),
            "exchange_per_superstep": int(r.exchange_per_superstep),
            "total_exchanged": int(r.total_exchanged)}


def _inputs(g, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    v = g.n_vertices
    p = rng.random(v).astype(np.float32)
    return {"labels": rng.permutation(v).astype(np.float32) * 0.5 + 3.0,
            "p": (p / p.sum()).astype(np.float32),
            "x": rng.normal(size=(v, TE.GCN_F_IN)).astype(np.float32),
            "weight": rng.normal(size=(TE.GCN_F_IN, TE.GCN_F_OUT)).astype(
                np.float32),
            "entity": rng.normal(size=(v, TE.KGE_F)).astype(np.float32),
            "relation": rng.normal(size=(g.e_pad, TE.KGE_F)).astype(
                np.float32)}


def _run_all(mod, eng, deg, inp) -> dict:
    """Every program of the slice through one package's entry points."""
    return {"wsssp": mod.engine_weighted_sssp(eng, SOURCE),
            "bfs": mod.engine_bfs(eng, SOURCE),
            "labelprop": mod.engine_label_propagation(eng, inp["labels"]),
            "ppr": mod.engine_personalized_pagerank(eng, deg, inp["p"]),
            "gcn_layer": mod.engine_gcn_layer(eng, deg, inp["x"],
                                              inp["weight"]),
            "kge_score": mod.engine_kge_score(eng, inp["entity"],
                                              inp["relation"])}


CASES = ("dfep", "patched")


@pytest.fixture(scope="module")
def program_runs(setup):
    """case -> (reference graph, inputs, reference results, port results).
    "dfep": the whole slice, each package partitioning with its own DFEP
    from the same starts; "patched": the patched plan carried across."""
    g, plans = setup
    inp = _inputs(g)
    owner, _ = RD.partition(g, k=4, key=0, max_rounds=400, stall_rounds=16)
    gt = TG.graph_from_numpy(g, device=CPU)
    starts = np.asarray(jax.random.choice(jax.random.key(0), g.n_vertices,
                                          shape=(4,), replace=False))
    owner_t, _ = TD.partition(gt, k=4, starts=starts, max_rounds=400,
                              stall_rounds=16, device=CPU)
    np.testing.assert_array_equal(owner_t.numpy(), np.asarray(owner))
    pairs = {"dfep": (E.compile_plan(g, owner, 4),
                      TE.compile_plan(gt, owner_t, 4, device=CPU)),
             "patched": (plans["patched"], _port(plans["patched"]))}
    out = {}
    for case, (ref_plan, port_plan) in pairs.items():
        ref = _run_all(E, E.Engine(ref_plan), g.degrees(), inp)
        port = _run_all(TE, TE.Engine(port_plan), gt.degrees(), inp)
        out[case] = (g, inp, ref, port)
    return out


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("prog", ["wsssp", "bfs", "labelprop"])
def test_min_programs_bit_identical(program_runs, case, prog):
    _, _, ref, port = program_runs[case]
    assert port[prog].state.dtype == torch.float32
    np.testing.assert_array_equal(port[prog].state.numpy(),
                                  np.asarray(ref[prog].state))
    assert port[prog].row() == _row(ref[prog])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("prog", ["ppr", "gcn_layer", "kge_score"])
def test_add_programs_match_reference(program_runs, case, prog):
    _, _, ref, port = program_runs[case]
    want = np.asarray(ref[prog].state)
    got = port[prog].state.numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    rtol = KGE_RTOL if prog == "kge_score" else 0.0
    atol = KGE_ATOL if prog == "kge_score" else ADD_ATOL
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    assert port[prog].row() == _row(ref[prog])


def test_programs_match_oracles(program_runs):
    """The whole slice (the port's DFEP and plan) against the dense oracles
    in ``repro.core.algorithms``."""
    g, inp, _, port = program_runs["dfep"]
    st = {k: r.state.numpy() for k, r in port.items()}
    np.testing.assert_array_equal(st["wsssp"],
                                  alg.reference_weighted_sssp(g, SOURCE))
    np.testing.assert_array_equal(st["bfs"], alg.reference_bfs(g, SOURCE))
    np.testing.assert_array_equal(
        st["labelprop"], alg.reference_label_propagation(g, inp["labels"]))
    np.testing.assert_allclose(
        st["ppr"], alg.reference_personalized_pagerank(g, inp["p"]),
        rtol=0, atol=ADD_ATOL)
    np.testing.assert_allclose(
        st["gcn_layer"], alg.reference_gcn_layer(g, inp["x"], inp["weight"]),
        rtol=0, atol=ADD_ATOL)
    np.testing.assert_allclose(
        st["kge_score"],
        alg.reference_kge_score(g, inp["entity"], inp["relation"]),
        rtol=KGE_RTOL, atol=KGE_ATOL)
    assert st["gcn_layer"].shape == (g.n_vertices, TE.GCN_F_OUT)
    assert st["kge_score"].shape == (g.n_vertices,)


def test_gnn_plain_engine_equals_kernel_engine_on_cpu(setup, program_runs):
    """use_kernels=False (gspmm_ref) and the wrappers on CPU tensors run the
    same plain code: equal results, no launches."""
    g, inp, _, port = program_runs["patched"]
    eng = TE.Engine(_port(setup[1]["patched"]), use_kernels=False)
    before = dict(TK.LAUNCHES)
    plain = _run_all(TE, eng, TG.graph_from_numpy(g, device=CPU).degrees(),
                     inp)
    assert TK.LAUNCHES == before
    for name, r in plain.items():
        assert torch.equal(r.state, port[name].state), name
        assert r.row() == port[name].row()


# ---------------------------------------------------------------------------
# F=1 lifted hooks == the scalar path, bit for bit
# ---------------------------------------------------------------------------

def _lift(base):
    """Clone a scalar program with hooks carrying [K, Vmax, 1] planes."""
    def init(plan, ctx):
        return base.init(plan, ctx)[:, :, None]

    def pre(state, ctx):
        return base.pre(state[:, :, 0], ctx)[:, :, None]

    def apply(old, agg, ctx):
        return base.apply(old[:, :, 0], agg[:, :, 0], ctx)[:, :, None]

    def finalize(glob, present, plan, ctx):
        return base.finalize(glob[:, 0], present, plan, ctx)

    return base._replace(name=f"vec_{base.name}", init=init, pre=pre,
                         apply=apply, finalize=finalize, warm_init=None)


@pytest.mark.parametrize("prog", ["sssp", "pagerank"])
def test_f1_lifted_program_bit_identical(prog):
    g = TG.watts_strogatz(150, 4, 0.15, seed=1, device=CPU)
    owner = baselines.hash_partition(RG.watts_strogatz(150, 4, 0.15, seed=1),
                                     4)
    eng = TE.Engine(TE.compile_plan(g, np.asarray(owner), 4, device=CPU))
    if prog == "sssp":
        kw = {"source": 0}
        base = TE.SSSP
    else:
        kw = {"max_supersteps": 15, "degrees": g.degrees()}
        base = TE.PAGERANK
    scalar = eng.run(base, **kw)
    vec = eng.run(_lift(base), **kw)
    assert torch.equal(scalar.state, vec.state)
    assert scalar.row() == vec.row()

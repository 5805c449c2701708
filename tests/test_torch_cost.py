"""The port's cost attribution (``repro_torch.obs.profile`` / ``ledger`` /
``usage`` and ``GraphServer(ledger=...)``) on the CPU: the tests of
``tests/test_cost.py`` that have a counterpart (the HLO parser has none:
the port counts a sweep from the plan), then the port against the
reference — one seeded ``CostSample`` sequence gives equal ledger dumps,
each package's ``usage`` renders the other's dump to the same text, and
one seeded request stream with the same pre-posted samples gets the same
admissions, flush order and values from both servers — and a hand count
on a written-out K = 2 plan against ``cost_model``'s bytes."""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the reference below runs on the CPU backend)

from repro import engine as E
from repro import gserve as G
from repro import obs as robs
from repro.core import baselines as RB
from repro.core import graph as RG
from repro.obs import ledger as rledger
from repro.obs import usage as rusage
from repro_torch import engine as TE
from repro_torch import gserve as TG
from repro_torch import obs
from repro_torch.core import baselines, graph
from repro_torch.engine import kernels
from repro_torch.engine.registry import get_program
from repro_torch.gserve.request import AdmissionError
from repro_torch.gserve.scheduler import MicroBatcher
from repro_torch.obs import profile, usage
from repro_torch.obs.ledger import CostLedger, CostSample, get_ledger

CPU = "cpu"
ADD_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _clean_profile_cache():
    """The model cache and recorders are process-global; leave them clean
    for whichever test runs next."""
    profile.reset_models()
    for o in (obs, robs):
        o.disable()
        o.reset()
    yield
    profile.reset_models()
    for o in (obs, robs):
        o.disable()
        o.reset()


def _engine(n=120, k=4, seed=3):
    g = graph.watts_strogatz(n, 4, 0.2, seed=seed, device=CPU)
    plan = TE.compile_plan(g, baselines.hash_partition(g, k), k, device=CPU)
    return g, TE.Engine(plan)


def _kw(g, eng, kind, params):
    """The ctx arguments the serving path would dispatch with."""
    entry = get_program(kind)
    params = TG.QueryRequest(kind, params=params).params
    kw = {name: fn(g) for name, fn in entry.resources}
    kw.update(entry.ctx_args(params))
    kw.update(entry.channel_args(params, eng.plan))
    return entry, kw


def _model(g, eng, kind, params, lanes=None):
    entry, kw = _kw(g, eng, kind, params)
    bkw = None if lanes is None else {
        "source": torch.zeros(lanes, dtype=torch.int32)}
    return profile.cost_model(eng, entry.program, bucket=lanes,
                              batched_kw=bkw, **kw)


# ---------------------------------------------------------------------------
# obs.profile: the per-sweep count and its memo
# ---------------------------------------------------------------------------

def test_cost_model_costs_positive_and_monotone_in_graph_size():
    """Price the batched SSSP and the PageRank sweep at two graph sizes:
    flops/bytes positive, finite, and monotone."""
    costs = {}
    for n in (120, 240):
        g, eng = _engine(n=n)
        sssp = _model(g, eng, "sssp", {"source": 0}, lanes=4)
        pr = _model(g, eng, "pagerank", {"iters": 5})
        for m in (sssp, pr):
            assert m.error is None and m.unmodeled_ops == 0
            assert m.flops_per_sweep > 0 and np.isfinite(m.flops_per_sweep)
            assert m.hbm_bytes_per_sweep > 0
            assert np.isfinite(m.hbm_bytes_per_sweep)
            assert m.coll_bytes_per_sweep == 0 and m.hlo_chars == 0
        costs[n] = (sssp, pr)
    (s_small, p_small), (s_big, p_big) = costs[120], costs[240]
    assert s_big.flops_per_sweep > s_small.flops_per_sweep
    assert s_big.hbm_bytes_per_sweep > s_small.hbm_bytes_per_sweep
    assert p_big.flops_per_sweep > p_small.flops_per_sweep
    assert p_big.hbm_bytes_per_sweep > p_small.hbm_bytes_per_sweep


def test_cost_model_memoized_per_shape():
    g, eng = _engine()
    m1 = _model(g, eng, "sssp", {"source": 0}, lanes=4)
    assert m1.error is None
    assert m1.flops_per_sweep > 0 and m1.hbm_bytes_per_sweep > 0
    assert m1.compile_s > 0
    m2 = _model(g, eng, "sssp", {"source": 0}, lanes=4)
    assert m2 is m1                                  # cache hit
    st = profile.profile_stats()
    assert st["hits"] == 1 and st["misses"] == 1 and st["errors"] == 0
    # a different bucket is a different shape -> a fresh model
    m3 = _model(g, eng, "sssp", {"source": 0}, lanes=8)
    assert m3 is not m1 and profile.profile_stats()["misses"] == 2
    assert m3.hbm_bytes_per_sweep > m1.hbm_bytes_per_sweep
    # a plan with other live counts (one edge fewer) is another model
    emask = eng.plan.emask.clone()
    emask[0, int(torch.nonzero(emask[0])[0])] = False
    fewer = TE.Engine(dataclasses.replace(eng.plan, emask=emask))
    m4 = _model(g, fewer, "sssp", {"source": 0}, lanes=4)
    assert m4 is not m1 and m4.flops_per_sweep < m1.flops_per_sweep
    # cost() scales linearly in sweeps; attainable_s is a positive bound
    fl1, by1, _ = m1.cost(1)
    fl3, by3, _ = m1.cost(3)
    assert fl3 == pytest.approx(3 * fl1) and by3 == pytest.approx(3 * by1)
    assert m1.attainable_s(3) > 0


def test_cost_model_never_raises():
    g, eng = _engine()

    class Boom:
        plan = eng.plan
        group = object()            # sharded: the count asks for the block

        def _local_plan(self):
            raise RuntimeError("sharding exploded")

    m = profile.cost_model(Boom(), get_program("sssp").program, bucket=4)
    assert m.error is not None and "sharding exploded" in m.error
    assert m.cost(10) == (0.0, 0.0, 0.0)
    # the error model is cached too: a persistently broken count is paid
    # for once, not per dispatch
    m2 = profile.cost_model(Boom(), get_program("sssp").program, bucket=4)
    assert m2 is m
    st = profile.profile_stats()
    assert st["errors"] == 1 and st["hits"] == 1
    # an engine that is not one at all degrades the same way
    m3 = profile.cost_model(object(), get_program("sssp").program)
    assert m3.error is not None and m3.cost(1) == (0.0, 0.0, 0.0)


def _hand_plan():
    """The path 0-1-2-3 with edges (0,1), (1,2) in partition 0 and (2,3)
    in partition 1: partition 0 holds vertices 0, 1, 2 and four
    half-edges, partition 1 vertices 2, 3 and two; vertex 2 is in both."""
    g = graph.from_edge_array(4, np.array([[0, 1], [1, 2], [2, 3]]),
                              device=CPU)
    owner = np.zeros(g.e_pad, np.int64)
    owner[2] = 1
    return g, TE.Engine(TE.compile_plan(g, owner, 2, device=CPU))


def test_hand_count_on_a_tiny_plan_equals_cost_model():
    """``cost_model``'s per-sweep bytes on the written-out K = 2 plan,
    counted by hand: WCC (one lane: pre, gather, segment_reduce, apply,
    the local change test, the exchange, the superstep change test) and
    BFS over 4 lanes (its edge hook and the two lane masks too)."""
    g, eng = _hand_plan()
    plan = eng.plan
    k, vmax, emax = 2, 128, 128        # compile_plan pads to 128 slots
    assert (plan.k, plan.v_max, plan.e_max) == (k, vmax, emax)
    kv, ke = k * vmax, k * emax
    live = 6                           # half-edges: 4 + 2
    append_live = 0                    # a fresh plan has no append region
    nbr_rows = 3 + 2                   # distinct neighbours: {0,1,2}, {2,3}
    live_slots, private, rep_slots, groups = 5, 3, 2, 1
    assert tuple(kernels.plan_counts(plan)) == (
        live, append_live, nbr_rows, live_slots, private, rep_slots, groups)

    def sweep_bytes(f, edge_hook, lanes):
        seg = (4 * f * live + 2 * ke + 5 * kv + 4 * k + 4 * append_live
               + 4 * f * kv)
        exchange = (4 * f * live_slots + 4 * (rep_slots + groups + 1)
                    + 2 * kv + 4 * f * kv)
        pre, apply_, test = 8 * f * kv, 12 * f * kv, 8 * f * kv
        gather = 8 * ke + 4 * f * kv + 4 * f * ke
        edge = 8 * f * ke if edge_hook else 0
        masks = 2 * 12 * f * kv if lanes > 1 else 0
        return (pre + gather + edge + seg + apply_ + test + masks + exchange
                + test)

    wcc = _model(g, eng, "wcc", {})
    assert wcc.hbm_bytes_per_sweep == sweep_bytes(1, False, 1) == 17732
    # flops: one per element of each plane op, one combine per message
    assert wcc.flops_per_sweep == 4 * kv + live
    bfs = _model(g, eng, "bfs", {"source": 0}, lanes=4)
    assert bfs.hbm_bytes_per_sweep == sweep_bytes(4, True, 4)
    assert bfs.flops_per_sweep == 4 * (6 * kv + ke + live)


def _seg_bound_bytes(plan, f):
    """chip_smoke.py's segment_reduce byte count as it was written inline
    before the counts moved beside the kernels."""
    kv, ke = plan.k * plan.v_max, plan.k * plan.e_max
    live = int(plan.emask.sum())
    slot = torch.arange(plan.e_max)[None, :]
    append_live = int((plan.emask & (slot >= plan.csr_fill[:, None])).sum())
    return (4 * f * live + 2 * ke + 5 * kv + 4 * plan.k + 4 * append_live
            + 4 * f * kv), f * live


def _gspmm_bound_bytes(plan, f, per_feature):
    kv, ke = plan.k * plan.v_max, plan.k * plan.e_max
    live = int(plan.emask.sum())
    slot = torch.arange(plan.e_max)[None, :]
    append_live = int((plan.emask & (slot >= plan.csr_fill[:, None])).sum())
    base = torch.arange(plan.k)[:, None] * plan.v_max
    rows = int(torch.unique((base + plan.edge_nbr.long())[plan.emask])
               .numel())
    weight = 4 * f if per_feature else 4
    return ((4 + weight) * live + 2 * ke + 5 * kv + 4 * plan.k
            + 4 * append_live + 4 * f * rows + 4 * f * kv), 2 * f * live


def _exchange_bytes(plan, f, glob_form):
    kv = plan.k * plan.v_max
    rep = plan.vmask & plan.replicated
    groups = int(torch.unique(plan.local2global[rep]).numel())
    if glob_form:                       # masked_update
        private = int((plan.vmask & ~plan.replicated).sum())
        return (4 * f * private + 4 * int(rep.sum()) + 4 * f * groups
                + 2 * kv + 4 * f * kv)
    return (4 * f * int(plan.vmask.sum()) + 4 * (int(rep.sum()) + groups + 1)
            + 2 * kv + 4 * f * kv)


@pytest.mark.parametrize("f", [1, 8, 32])
def test_work_counts_equal_the_kernel_bound_formulas(f):
    """The counts beside the kernels give the kernel table's bounds as
    ``chip_smoke.py`` computed them inline, on a fresh plan and on one with
    live append slots and deleted prefix slots."""
    g, eng = _engine(n=200, k=4)
    plan = eng.plan
    emask = plan.emask.clone()
    emask[:, 0] = False
    patched = dataclasses.replace(plan, emask=emask)
    for p in (plan, patched):
        by, fl = _seg_bound_bytes(p, f)
        assert kernels.segment_reduce_work(p, f) == (fl, by)
        for per_feature in (False, True):
            by, fl = _gspmm_bound_bytes(p, f, per_feature)
            assert kernels.gspmm_work(p, f, per_feature) == (fl, by)
        assert kernels.exchange_work(p, f) == (0, _exchange_bytes(p, f,
                                                                  False))
        assert kernels.masked_update_work(p, f) == (
            0, _exchange_bytes(p, f, True))


# ---------------------------------------------------------------------------
# CostLedger accounting
# ---------------------------------------------------------------------------

def _sample(tenant, device_s, program="sssp", graph_fp="g1", epoch=0, **kw):
    return CostSample(tenant=tenant, program=program, graph=graph_fp,
                      epoch=epoch, device_s=device_s, **kw)


def test_ledger_totals_shares_and_snapshot():
    led = CostLedger(window_s=30.0)
    led.post(_sample("a", 0.3, flops=3e6, utilization=0.5))
    led.post(_sample("a", 0.3, program="pagerank", flops=6e6))
    led.post(_sample("b", 0.2, flops=2e6, utilization=1.0))
    led.post(_sample("b", 0.0, from_cache=True))
    tot = led.totals()
    assert tot["series"] == 3
    assert tot["device_s"] == pytest.approx(0.8)
    assert tot["flops"] == pytest.approx(11e6)
    assert tot["requests"] == 4
    assert tot["dispatched"] == 3 and tot["cached"] == 1
    shares = led.tenant_shares(None)
    assert sum(shares.values()) == pytest.approx(1.0)
    assert shares["a"] == pytest.approx(0.75)
    win = led.tenant_shares(30.0)
    assert win["a"] == pytest.approx(0.75, rel=1e-6)
    snap = led.snapshot()
    assert snap["kind"] == "cost_ledger"
    assert set(snap["tenants"]) == {"a", "b"}
    assert snap["tenants"]["b"]["cached"] == 1
    assert snap["tenants"]["b"]["utilization"] == pytest.approx(1.0)
    assert len(snap["series"]) == 3


def test_ledger_merge_is_additive():
    a, b = CostLedger(), CostLedger()
    a.post(_sample("a", 0.5, flops=1e6))
    b.post(_sample("a", 0.25, flops=2e6))
    b.post(_sample("c", 0.25))
    a.merge(b)
    tot = a.totals()
    assert tot["device_s"] == pytest.approx(1.0)
    assert tot["flops"] == pytest.approx(3e6)
    assert tot["series"] == 2                  # same-key series folded
    assert a.tenant_shares(None)["a"] == pytest.approx(0.75)


def test_served_workload_reconciles_with_device_time():
    """Ledger device seconds == the server's ``device_time_s`` (±1%), and
    every completed request lands in exactly one series (cache hits
    included). Each dispatched batch's device seconds include its
    superstep loop: they are at least its ``serve.dispatch`` span."""
    g, eng = _engine(n=150)
    led = CostLedger(window_s=30.0)
    obs.enable()
    srv = TG.GraphServer(eng, g, buckets=(1, 4), ledger=led)
    reqs = [TG.QueryRequest("sssp", tenant="a", params={"source": s})
            for s in (0, 1, 2)]
    reqs += [TG.QueryRequest("pagerank", tenant="b", params={"iters": 5}),
             TG.QueryRequest("wcc", tenant="b")]
    srv.serve(reqs)
    rep = srv.serve([TG.QueryRequest("sssp", tenant="a",
                                     params={"source": 0})])[0]
    assert rep.from_cache
    tot = led.totals()
    dev = srv.metrics.device_time_s
    assert dev > 0
    assert abs(tot["device_s"] - dev) <= 0.01 * dev
    assert tot["requests"] == srv.metrics.n_completed == 6
    assert tot["dispatched"] == 5 and tot["cached"] == 1
    snap = led.snapshot()
    for agg in snap["tenants"].values():
        assert 0.0 < agg["utilization"]
    assert tot["flops"] > 0 and tot["hbm_bytes"] > 0
    events = obs.get().events()
    dispatch = {e["args"]["parent_id"]: e["dur"] for e in events
                if e["name"] == "serve.dispatch"}
    execute = {e["args"]["parent_id"]: e["args"]["device_s"]
               for e in events if e["name"] == "serve.execute"}
    assert len(dispatch) == len(execute) == 3        # sssp, pagerank, wcc
    assert set(dispatch) == set(execute)
    for batch, dur_us in dispatch.items():
        assert execute[batch] * 1e6 >= dur_us, batch
    assert sum(execute.values()) == pytest.approx(dev, rel=1e-9)
    srv.close()


def test_every_registered_program_is_priced():
    """One request of every built-in program through a ledger-wired
    server: each dispatch's model counts its sweep (no error, nothing
    unmodeled) and each sample's utilization is positive."""
    g, eng = _engine(n=120)
    n = g.n_vertices
    rng = np.random.default_rng(4)
    params = {
        "sssp": {"source": 3}, "bfs": {"source": 5}, "wsssp": {"source": 7},
        "wcc": {}, "pagerank": {"iters": 4},
        "ppr": {"personalization": np.full(n, 1.0 / n), "iters": 4},
        "labelprop": {"labels": rng.permutation(n).astype(np.float64)},
        "gcn_layer": {"x": rng.normal(size=(n, TE.GCN_F_IN)),
                      "weight": rng.normal(size=(TE.GCN_F_IN,
                                                 TE.GCN_F_OUT))},
        "kge_score": {"entity": rng.normal(size=(n, TE.KGE_F)),
                      "relation": rng.normal(size=(g.e_pad, TE.KGE_F))}}
    assert set(params) <= set(TE.program_names())
    led = CostLedger()
    srv = TG.GraphServer(eng, g, ledger=led)
    out = srv.serve([TG.QueryRequest(kind, tenant=kind, params=prm)
                     for kind, prm in params.items()])
    assert all(r.error is None for r in out)
    models = list(profile._MODELS.values())
    assert {m.program for m in models} == set(params)
    for m in models:
        assert m.error is None and m.unmodeled_ops == 0, m
        assert m.flops_per_sweep > 0 and m.hbm_bytes_per_sweep > 0, m
    rows = led.snapshot()["series"]
    assert len(rows) == len(params)
    for row in rows:
        assert row["utilization"] > 0, row
    srv.close()


# ---------------------------------------------------------------------------
# cost-weighted serving behaviour
# ---------------------------------------------------------------------------

def test_cost_weighted_admission_shrinks_overdrawn_quota():
    """With the ledger showing one tenant holding ~90% of the windowed
    device time, its count-based pending quota (max_pending//n_active)
    shrinks by fair/used; the under-budget tenant keeps the full quota."""
    g, eng = _engine()

    def fill(srv):
        srv.submit(TG.QueryRequest("sssp", tenant="cheap",
                                   params={"source": 0}))
        n = 0
        try:
            for it in range(20):
                srv.submit(TG.QueryRequest("pagerank", tenant="heavy",
                                           params={"iters": 10 + it}))
                n += 1
        except AdmissionError:
            pass
        return n

    plain = TG.GraphServer(eng, g, max_pending=8, cache_entries=0)
    count_quota = fill(plain)
    plain.close()
    assert count_quota == 4                    # 8 max_pending / 2 active

    led = CostLedger(window_s=30.0)
    led.post(_sample("heavy", 0.9, program="pagerank"))
    led.post(_sample("cheap", 0.1))
    srv = TG.GraphServer(eng, g, max_pending=8, cache_entries=0, ledger=led)
    cost_quota = fill(srv)
    # fair=0.5, used=0.9 -> quota floor(4 * 0.5/0.9) = 2
    assert cost_quota == 2
    for s in range(1, 4):
        srv.submit(TG.QueryRequest("sssp", tenant="cheap",
                                   params={"source": s}))
    srv.set_ledger(None)                        # unwired: counts again
    assert srv.ledger is None and srv._batcher.cost_of is None
    srv.close()


def test_cost_weighted_flush_order_drains_cheap_tenant_first():
    b = MicroBatcher(buckets=(1, 4))
    heavy = TG.QueryRequest("pagerank", tenant="heavy", params={"iters": 7})
    cheap = TG.QueryRequest("sssp", tenant="cheap", params={"source": 0})
    b.add(heavy)
    b.add(cheap)
    assert b.next_batch().requests[0].tenant == "heavy"

    b2 = MicroBatcher(buckets=(1, 4))
    b2.cost_of = {"heavy": 0.9, "cheap": 0.1}.get
    b2.add(heavy)
    b2.add(cheap)
    first, second = b2.next_batch(), b2.next_batch()
    assert first.requests[0].tenant == "cheap"
    assert second.requests[0].tenant == "heavy"


# ---------------------------------------------------------------------------
# renderer + snapshot plumbing
# ---------------------------------------------------------------------------

def test_usage_renderer_loads_dump_and_obs_snapshot(tmp_path):
    led = CostLedger(window_s=30.0)
    led.post(_sample("alice", 0.6, flops=5e7, utilization=0.4))
    led.post(_sample("bob", 0.2, program="pagerank"))
    p = tmp_path / "usage_ledger.json"
    led.dump(str(p))
    text = usage.render(usage.load(str(p)))
    assert "alice" in text and "bob" in text and "pagerank" in text
    assert "USAGE LEDGER" in text
    from repro_torch.obs.ledger import register
    unregister = register(led, name="ledger_under_test")
    try:
        snap_path = tmp_path / "snap.json"
        snap_path.write_text(json.dumps(obs.snapshot(), default=str))
        doc = json.loads(snap_path.read_text())
        assert doc["ledger_under_test"]["kind"] == "cost_ledger"
        assert "alice" in usage.render(doc["ledger_under_test"])
    finally:
        unregister()


def test_ledger_rides_in_obs_snapshot_by_default():
    led = get_ledger()
    led.reset()
    led.post(_sample("snapshot-tenant", 0.1))
    try:
        found = usage._find_ledger(obs.snapshot())
        assert found is not None
        assert "snapshot-tenant" in found["tenants"]
        assert "cost_models" in obs.snapshot()
    finally:
        led.reset()


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------

def _seeded_samples(seed=7, n=60):
    """A seeded mixed sequence of sample fields: 3 tenants, 3 programs, 2
    graphs, 2 epochs, cache hits among them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        cached = bool(rng.random() < 0.2)
        out.append(dict(
            tenant=f"t{int(rng.integers(3))}",
            program=("sssp", "pagerank", "wcc")[int(rng.integers(3))],
            graph=("g0", "g1")[int(rng.integers(2))],
            epoch=int(rng.integers(2)),
            device_s=0.0 if cached else float(rng.uniform(1e-5, 0.2)),
            flops=0.0 if cached else float(rng.uniform(1e3, 1e9)),
            hbm_bytes=0.0 if cached else float(rng.uniform(1e3, 1e10)),
            coll_bytes=0.0,
            supersteps=0 if cached else int(rng.integers(1, 30)),
            from_cache=cached,
            utilization=0.0 if cached else float(rng.uniform(0.0, 1.0))))
    return out


def _ledgers(samples):
    ref, port = rledger.CostLedger(window_s=45.0), CostLedger(window_s=45.0)
    for s in samples:
        ref.post(rledger.CostSample(**s))
        port.post(CostSample(**s))
    return ref, port


def test_ledger_dump_matches_reference(tmp_path):
    """One seeded sample sequence posted into both ledgers: equal dumps,
    key for key, apart from the windowed share (each ledger's own clock);
    totals and lifetime shares equal; merged ledgers equal too."""
    ref, port = _ledgers(_seeded_samples())
    ref.dump(str(tmp_path / "ref.json"))
    port.dump(str(tmp_path / "port.json"))
    a = json.loads((tmp_path / "ref.json").read_text())
    b = json.loads((tmp_path / "port.json").read_text())
    for doc in (a, b):
        shares = {t: agg.pop("window_share")
                  for t, agg in doc["tenants"].items()}
        assert sum(shares.values()) == pytest.approx(1.0)
    assert a == b
    assert port.tenant_shares(None) == ref.tenant_shares(None)
    ref2, port2 = _ledgers(_seeded_samples(seed=8))
    assert port.merge(port2).totals() == ref.merge(ref2).totals()


def test_usage_renders_each_others_dumps(tmp_path):
    """``repro_torch.obs.usage`` renders the reference's dump to the
    reference's text, and ``repro.obs.usage`` the port's; a flight bundle
    carrying the port's ledger renders the same in both."""
    ref, port = _ledgers(_seeded_samples())
    ref.dump(str(tmp_path / "ref.json"))
    port.dump(str(tmp_path / "port.json"))
    for path in ("ref.json", "port.json"):
        p = str(tmp_path / path)
        for top in (3, 10):
            assert usage.render(usage.load(p), top=top) == \
                rusage.render(rusage.load(p), top=top)
    # the process-global ledger rides inside the port's flight bundle
    glob = get_ledger()
    glob.reset()
    for sample in _seeded_samples():
        glob.post(CostSample(**sample))
    try:
        path = str(obs.FlightRecorder(str(tmp_path / "fl")).dump("usage"))
    finally:
        glob.reset()
    text = usage.render(usage.load(path))
    assert text == rusage.render(rusage.load(path))
    assert "t0" in text and "USAGE LEDGER  (" in text


def _admit_and_drain(Q, srv, reqs):
    """Submit in order (recording admissions), then drain; returns the
    admitted flags, the submitted indices in completion order and the
    values by index."""
    admitted, index = [], {}
    for i, r in enumerate(reqs):
        try:
            index[srv.submit(r)] = i
            admitted.append(True)
        except (AdmissionError, G.AdmissionError):
            admitted.append(False)
    done = srv.drain()
    order = [index[r.request.id] for r in done]
    values = {index[r.request.id]: r for r in done}
    return admitted, order, values


def _cost_stream(Q, rng, n, count):
    tenants = ("heavy", "mid", "cheap")
    out = []
    for _ in range(count):
        t = tenants[int(rng.integers(3))]
        kind = ("sssp", "bfs", "pagerank", "wcc")[int(rng.integers(4))]
        params = {"iters": int(rng.integers(3, 6))} if kind == "pagerank" \
            else {} if kind == "wcc" else {"source": int(rng.integers(n))}
        out.append(Q.QueryRequest(kind, tenant=t, params=params))
    return out


@pytest.mark.parametrize("max_pending", [6, 24])
def test_cost_weighted_serving_matches_reference(max_pending):
    """One seeded request stream, with the same samples posted into both
    servers' ledgers first (heavy 60%, mid 30%, cheap 10% of the device
    time, far above what the stream adds): the same requests admitted, the
    same completion order (cost-weighted flushes and in-flight
    completion) and the same values as the reference's server."""
    rg = RG.watts_strogatz(150, 4, 0.2, seed=6)
    owner = RB.hash_partition(rg, 4)
    plan = E.compile_plan(rg, owner, 4)
    tg = graph.graph_from_numpy(rg, device=CPU)
    ref_led, port_led = rledger.CostLedger(), CostLedger()
    for tenant, dev in (("heavy", 600.0), ("mid", 300.0), ("cheap", 100.0)):
        ref_led.post(rledger.CostSample(tenant, "sssp", "pre", 0, dev))
        port_led.post(CostSample(tenant, "sssp", "pre", 0, dev))
    ref_srv = G.GraphServer(E.Engine(plan), rg, buckets=(1, 2, 4),
                            max_pending=max_pending, ledger=ref_led)
    port_srv = TG.GraphServer(TE.Engine(TE.plan_from_numpy(plan, device=CPU)),
                              tg, buckets=(1, 2, 4), max_pending=max_pending,
                              ledger=port_led)
    for burst in range(2):
        want = _admit_and_drain(G, ref_srv, _cost_stream(
            G, np.random.default_rng(20 + burst), 150, 30))
        got = _admit_and_drain(TG, port_srv, _cost_stream(
            TG, np.random.default_rng(20 + burst), 150, 30))
        assert got[0] == want[0]                     # admissions
        if max_pending == 6:
            assert not all(want[0])
        assert got[1] == want[1]                     # completion order
        for i, a in want[2].items():
            b = got[2][i]
            assert (b.from_cache, b.batch_size, b.bucket, b.supersteps) \
                == (a.from_cache, a.batch_size, a.bucket, a.supersteps)
            if a.request.entry.oracle_atol:
                np.testing.assert_allclose(b.value, a.value, rtol=0,
                                           atol=ADD_ATOL)
            else:
                np.testing.assert_array_equal(b.value, a.value)
    rt, pt = ref_led.totals(), port_led.totals()
    for key in ("series", "requests", "dispatched", "cached"):
        assert pt[key] == rt[key], key
    ref_srv.close()
    port_srv.close()


def test_obs_exports_the_reference_names():
    """``repro_torch.obs`` exports what ``repro.obs.__all__`` exports, and
    ``repro_torch.gserve`` what ``repro.gserve.__all__`` does."""
    assert sorted(obs.__all__) == sorted(robs.__all__)
    assert all(hasattr(obs, name) for name in obs.__all__)
    assert sorted(TG.__all__) == sorted(G.__all__)

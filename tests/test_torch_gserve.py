"""The port's serving stack (``repro_torch.gserve``) on the CPU: the
session-free tests of ``tests/test_gserve.py`` against the port's own
oracles (micro-batch formation, pad-to-bucket, validation and
normalization, mixed tenants, the shared result cache, admission and fair
share, the timer flush, dispatch handles), the double-buffered plan swap
through the epoch-change hook with warm-started repair, and one seeded
request stream served by both packages' servers: equal values (add
programs within 1e-5), equal ``from_cache`` flags and the same
micro-batches. Then ``GraphServer.from_session`` over both packages'
streaming sessions (``tests/test_gserve.py``'s stream tests, and the
session-bound channel tests of ``tests/test_gnn.py`` and
``tests/test_registry.py``): requests interleaved with patches give
equal values, cache flags, batches, versions and warm-repair counts, each
answer exact for the snapshot it was served from. ``ledger=`` wires a
``CostLedger`` (its serving tests are in ``tests/test_torch_cost.py``)."""
import time
import types

import numpy as np
import pytest
import torch

import jax

from repro import engine as E
from repro import gserve as G
from repro import stream as RS
from repro.core import baselines as RB
from repro.core import graph as RG
from repro_torch import engine as TE
from repro_torch import gserve as TG
from repro_torch import stream as TS
from repro_torch.core import algorithms as alg
from repro_torch.core import baselines
from repro_torch.core import graph

CPU = "cpu"
ADD_ATOL = 1e-5


def _static_server(n=150, k=4, seed=3, **kw):
    g = graph.watts_strogatz(n, 4, 0.2, seed=seed, device=CPU)
    plan = TE.compile_plan(g, baselines.hash_partition(g, k), k, device=CPU)
    return g, TG.GraphServer(TE.Engine(plan), g, **kw)


def _check(result, g):
    """Generic oracle check derived from the registry entry."""
    entry = result.request.entry
    ref = np.asarray(entry.oracle(g, **result.request.params))
    if entry.oracle_atol:
        np.testing.assert_allclose(result.value, ref, atol=entry.oracle_atol)
    else:
        assert np.array_equal(result.value, ref), result.request


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------

def test_bucket_for():
    assert TG.bucket_for(1, (1, 2, 4)) == 1
    assert TG.bucket_for(3, (1, 2, 4)) == 4
    assert TG.bucket_for(9, (1, 2, 4)) == 4      # clamped to largest
    assert TG.DEFAULT_BUCKETS == G.DEFAULT_BUCKETS


def test_microbatcher_coalescing_and_fifo():
    b = TG.MicroBatcher(buckets=(1, 2, 4))
    reqs = [TG.QueryRequest("sssp", tenant="a", params={"source": 1}),
            TG.QueryRequest("wcc", tenant="b"),
            TG.QueryRequest("sssp", tenant="b", params={"source": 2}),
            TG.QueryRequest("sssp", tenant="c", params={"source": 1}),
            TG.QueryRequest("wcc", tenant="c"),
            TG.QueryRequest("pagerank", tenant="a", params={"iters": 5})]
    for r in reqs:
        b.add(r)
    assert len(b) == 6
    m1 = b.next_batch()                 # sssp queue arrived first
    assert m1.key == ("sssp",) and len(m1.requests) == 3
    assert m1.params == (1, 2) and m1.lane == (0, 1, 0)
    assert m1.bucket == 2 and m1.padded_params == (1, 2)
    m2 = b.next_batch()                 # both wcc requests share one run
    assert m2.key == ("wcc",) and len(m2.requests) == 2 and m2.params is None
    assert b.next_batch().key == ("pagerank", ("iters", 5))
    assert b.next_batch() is None and len(b) == 0


def test_padded_params_repeat_last():
    b = TG.MicroBatcher(buckets=(4,))
    for s in (5, 9, 13):
        b.add(TG.QueryRequest("sssp", params={"source": s}))
    m = b.next_batch()
    assert m.bucket == 4 and m.padded_params == (5, 9, 13, 13)


def test_request_validation():
    with pytest.raises(ValueError):
        TG.QueryRequest("sssp")                   # missing source
    with pytest.raises(ValueError):
        TG.QueryRequest("betweenness")            # unknown kind


def test_param_normalization_pagerank_iters_default():
    a = TG.QueryRequest("pagerank")
    b = TG.QueryRequest("pagerank", params={"iters": 30})
    assert a.params == b.params == {"iters": 30}
    assert a.batch_key() == b.batch_key() and a.cache_key() == b.cache_key()
    assert TG.QueryRequest("pagerank",
                           params={"iters": 10}).batch_key() != a.batch_key()
    _, srv = _static_server()
    r1 = srv.serve([TG.QueryRequest("pagerank")])[0]
    r2 = srv.serve([TG.QueryRequest("pagerank", params={"iters": 30})])[0]
    assert not r1.from_cache and r2.from_cache


# ---------------------------------------------------------------------------
# static serving
# ---------------------------------------------------------------------------

def test_serve_matches_oracles_mixed_tenants():
    g, srv = _static_server(buckets=(1, 2, 4, 8))
    reqs = [TG.QueryRequest("sssp", tenant=f"t{i % 3}",
                            params={"source": (i * 7) % 150})
            for i in range(10)]
    reqs += [TG.QueryRequest("wcc", tenant="t3"),
             TG.QueryRequest("wcc", tenant="t4"),
             TG.QueryRequest("pagerank", tenant="t5", params={"iters": 10})]
    out = srv.serve(reqs)
    assert [r.request.id for r in out] == [r.id for r in reqs]
    for r in out:
        _check(r, g)
    st = srv.stats()
    assert st["completed"] == 13 and st["batches"] <= 4
    assert st["mean_batch_occupancy"] > 1.0


def test_serve_registered_programs():
    """wsssp, BFS and the channel programs are served from their registry
    entries alone, oracle-exact (add programs within their tolerance)."""
    g, srv = _static_server(buckets=(1, 2, 4))
    rng = np.random.default_rng(4)
    lab = rng.integers(0, 30, g.n_vertices).astype(np.float32)
    pers = rng.random(g.n_vertices).astype(np.float32)
    reqs = [TG.QueryRequest("wsssp", tenant="a", params={"source": 3}),
            TG.QueryRequest("wsssp", tenant="b", params={"source": 11}),
            TG.QueryRequest("bfs", tenant="a", params={"source": 3}),
            TG.QueryRequest("bfs", tenant="c", params={"source": 40}),
            TG.QueryRequest("labelprop", params={"labels": lab}),
            TG.QueryRequest("ppr", params={"personalization": pers,
                                           "iters": 10}),
            TG.QueryRequest("gcn_layer", params={
                "x": rng.normal(size=(g.n_vertices, TE.GCN_F_IN)),
                "weight": rng.normal(size=(TE.GCN_F_IN, TE.GCN_F_OUT))}),
            TG.QueryRequest("kge_score", params={
                "entity": rng.normal(size=(g.n_vertices, TE.KGE_F)),
                "relation": rng.normal(size=(g.e_pad, TE.KGE_F)) / 4})]
    for r in srv.serve(reqs):
        _check(r, g)
    r2 = srv.serve([TG.QueryRequest("wsssp", tenant="z",
                                    params={"source": 3})])[0]
    assert r2.from_cache


def test_result_cache_shared_across_tenants():
    _, srv = _static_server()
    a = srv.serve([TG.QueryRequest("sssp", tenant="a",
                                   params={"source": 11})])[0]
    b = srv.serve([TG.QueryRequest("sssp", tenant="b",
                                   params={"source": 11})])[0]
    assert not a.from_cache and b.from_cache
    assert np.array_equal(a.value, b.value)
    w1 = srv.serve([TG.QueryRequest("wcc", tenant="a")])[0]
    w2 = srv.serve([TG.QueryRequest("wcc", tenant="b")])[0]
    assert not w1.from_cache and w2.from_cache
    assert srv.stats()["result_cache"]["hits"] >= 2
    for res in (a, b, w1, w2):
        with pytest.raises(ValueError):
            res.value[0] = -1.0


def test_admission_control():
    _, srv = _static_server(max_pending=2)
    srv.submit(TG.QueryRequest("sssp", params={"source": 1}))
    srv.submit(TG.QueryRequest("sssp", params={"source": 2}))
    with pytest.raises(TG.AdmissionError):
        srv.submit(TG.QueryRequest("sssp", params={"source": 3}))
    assert srv.stats()["rejected"] == 1
    assert len(srv.drain()) == 2
    srv.submit(TG.QueryRequest("sssp", params={"source": 3}))
    assert len(srv.drain()) == 1


def test_fair_share_admission_no_starvation():
    g, srv = _static_server(max_pending=8)
    admitted = 0
    with pytest.raises(TG.AdmissionError):
        for i in range(20):
            srv.submit(TG.QueryRequest("sssp", tenant="hog",
                                       params={"source": i}))
            admitted += 1
    assert admitted == 8
    qid = srv.submit(TG.QueryRequest("sssp", tenant="quiet",
                                     params={"source": 99}))
    with pytest.raises(TG.AdmissionError, match="fair share"):
        srv.submit(TG.QueryRequest("sssp", tenant="hog",
                                   params={"source": 50}))
    assert srv.stats()["rejected_fair_share"] >= 1
    served = {r.request.id: r for r in srv.drain()}
    assert qid in served
    _check(served[qid], g)
    srv.submit(TG.QueryRequest("sssp", tenant="hog", params={"source": 50}))
    assert len(srv.drain()) == 1
    n_in = 0
    with pytest.raises(TG.AdmissionError, match="hard limit"):
        for i in range(1000):
            srv.submit(TG.QueryRequest("sssp", tenant=f"fresh{i}",
                                       params={"source": i % 150}))
            n_in += 1
    assert n_in == 2 * 8
    srv.drain()


def test_timer_flush_bounds_partial_bucket_wait():
    g, srv = _static_server(buckets=(4,), max_wait_s=0.15)
    for s in (1, 2, 3):
        srv.submit(TG.QueryRequest("sssp", params={"source": s}))
    t0 = time.perf_counter()
    out = srv.drain()
    waited = time.perf_counter() - t0
    assert len(out) == 3 and all(r.bucket == 4 for r in out)
    assert waited >= 0.12, "partial bucket must wait toward the deadline"
    for r in out:
        _check(r, g)
    srv.max_wait_s = 30.0
    for s in (20, 21, 22, 23):
        srv.submit(TG.QueryRequest("sssp", params={"source": s}))
    t0 = time.perf_counter()
    out = srv.drain()
    assert len(out) == 4 and time.perf_counter() - t0 < 5.0


def test_pad_to_bucket_lanes():
    """Bursts of any size up to the bucket dispatch that bucket's lanes;
    the padding lanes' answers are dropped."""
    g, srv = _static_server(buckets=(4,))
    for sources in ((20, 21), (30, 31, 32, 33), (40, 41, 42)):
        out = srv.serve([TG.QueryRequest("sssp", params={"source": s})
                         for s in sources])
        for r in out:
            _check(r, g)
            assert r.bucket == 4 and r.batch_size == len(sources)
    st = srv.stats()
    assert st["batches"] == 3 and st["pad_waste_frac"] == pytest.approx(
        1 - 9 / 12)


def test_dispatch_handles_settle_out_of_order():
    g, srv = _static_server()
    eng = srv.front.engine
    p1 = eng.dispatch_batched(TE.SSSP, {"source": np.array([0, 5],
                                                           np.int32)})
    p2 = eng.dispatch_batched(TE.SSSP, {"source": np.array([9, 2],
                                                           np.int32)})
    r2, r1 = p2.result(), p1.result()
    for res, sources in ((r1, (0, 5)), (r2, (9, 2))):
        for i, s in enumerate(sources):
            ref, _ = alg.reference_sssp(g, s)
            assert torch.equal(res.state[i], ref)


def test_channel_mixup_shed_at_the_door():
    g, srv = _static_server()
    with pytest.raises(TE.ChannelError, match="VERTEX channel"):
        srv.submit(TG.QueryRequest("labelprop",
                                   params={"labels": np.zeros(g.e_pad)}))
    assert srv.pending() == 0


def test_ledger_is_not_ported():
    """The ledger once raised ``NotImplementedError`` here; now
    ``GraphServer(ledger=...)`` and ``set_ledger`` wire it (and unwire it
    with ``None``), and a wired server posts one sample a request."""
    from repro_torch.obs import CostLedger
    g, srv = _static_server()
    led = CostLedger()
    wired = TG.GraphServer(srv.front.engine, g, ledger=led)
    assert wired.ledger is led and wired._batcher.cost_of is not None
    wired.serve([TG.QueryRequest("sssp", params={"source": 1})])
    assert led.totals()["requests"] == 1
    srv.set_ledger(led)
    assert srv.ledger is led
    srv.set_ledger(None)
    assert srv.ledger is None and srv._batcher.cost_of is None
    wired.close()


# ---------------------------------------------------------------------------
# the double-buffered plan swap (the epoch-change hook a session calls)
# ---------------------------------------------------------------------------

def _session(g, k, version, delta):
    plan = TE.compile_plan(g, baselines.hash_partition(g, k), k, device=CPU)
    return types.SimpleNamespace(engine=TE.Engine(plan), graph=lambda: g,
                                 epoch=0, version=version,
                                 last_change={"content_delta": delta})


def test_plan_swap_invalidates_and_warm_starts():
    """An insert-only swap: the front buffer is replaced, cached answers of
    the old snapshot are dropped, and a repeated query warm-starts from
    the old answer and equals the oracle on the new graph. A swap with a
    deletion clears the warm store: no lane warm-starts after it."""
    g, srv = _static_server(buckets=(1, 2, 4))
    sources = (0, 17, 45)
    before = srv.serve([TG.QueryRequest("sssp", params={"source": s})
                        for s in sources])
    u, v = g.as_numpy()
    grown = graph.from_edge_array(
        g.n_vertices, np.concatenate([np.stack([u, v], 1),
                                      [[0, 80], [17, 120], [45, 140]]]),
        device=CPU)
    srv._on_plan_change(_session(grown, 4, 1, "insert_only"), "patch")
    assert srv.front.version == 1 and srv.stats()["plan_buffer_swaps"] == 1
    after = srv.serve([TG.QueryRequest("sssp", params={"source": s})
                       for s in sources])
    for old, r in zip(before, after):
        assert r.version == 1 and not r.from_cache and r.warm_start
        assert r.supersteps <= old.supersteps
        _check(r, grown)
    assert srv.stats()["warm_started_lanes"] == len(sources)
    assert srv.serve([TG.QueryRequest("sssp", params={"source": 0})])[0] \
        .from_cache
    srv._on_plan_change(_session(g, 4, 2, "mixed"), "recompile")
    again = srv.serve([TG.QueryRequest("sssp", params={"source": s})
                       for s in sources])
    for r in again:
        assert r.version == 2 and not r.warm_start and not r.from_cache
        _check(r, g)


# ---------------------------------------------------------------------------
# one seeded stream through both packages' servers
# ---------------------------------------------------------------------------

def _stream(Q, rng, n, planes, count):
    """A seeded request stream from four tenants: sssp/bfs/wsssp sources
    (a quarter repeating), wcc, pagerank 10 and 20, ppr, labelprop, one
    gcn_layer; ``Q`` is either package's gserve."""
    kinds = []
    for i in range(count):
        roll = rng.random()
        if roll < 0.75:
            kind = ("sssp", "bfs", "wsssp")[i % 3]
            src = int(rng.integers(n)) if rng.random() > 0.25 else i % 5
            kinds.append((kind, {"source": src}))
        else:
            kinds.append([("wcc", {}), ("pagerank", {"iters": 10}),
                          ("pagerank", {"iters": 20}),
                          ("ppr", {"personalization": planes["p"],
                                   "iters": 10}),
                          ("labelprop", {"labels": planes["labels"]})][i % 5])
    kinds.append(("gcn_layer", {"x": planes["x"], "weight": planes["w"]}))
    return [Q.QueryRequest(kind, tenant=f"t{i % 4}", params=params)
            for i, (kind, params) in enumerate(kinds)]


@pytest.mark.parametrize("buckets", [(1, 2, 4, 8), (4, 16)])
def test_seeded_stream_matches_reference_server(buckets):
    rg = RG.barabasi_albert(150, 3, seed=5)
    owner = RB.hash_partition(rg, 4)
    plan = E.compile_plan(rg, owner, 4)
    tg = graph.graph_from_numpy(rg, device=CPU)
    ref_srv = G.GraphServer(E.Engine(plan), rg, buckets=buckets)
    port_srv = TG.GraphServer(TE.Engine(TE.plan_from_numpy(plan, device=CPU)),
                              tg, buckets=buckets)
    rng = np.random.default_rng(11)
    p = rng.random(150)
    planes = {"p": (p / p.sum()).astype(np.float32),
              "labels": rng.permutation(150).astype(np.float32),
              "x": rng.normal(size=(150, TE.GCN_F_IN)).astype(np.float32),
              "w": rng.normal(size=(TE.GCN_F_IN,
                                    TE.GCN_F_OUT)).astype(np.float32)}
    for burst in range(2):      # the second burst meets a warm cache
        seed = 100 + burst
        want = ref_srv.serve(_stream(G, np.random.default_rng(seed), 150,
                                     planes, 40))
        got = port_srv.serve(_stream(TG, np.random.default_rng(seed), 150,
                                     planes, 40))
        assert len(got) == len(want)
        for a, b in zip(want, got):
            assert b.request.kind == a.request.kind
            assert (b.from_cache, b.batch_size, b.bucket, b.supersteps,
                    b.warm_start) == (a.from_cache, a.batch_size, a.bucket,
                                      a.supersteps, a.warm_start), a.row()
            if a.request.entry.oracle_atol:
                np.testing.assert_allclose(b.value, a.value, rtol=0,
                                           atol=ADD_ATOL)
            else:
                np.testing.assert_array_equal(b.value, a.value)
    ref_st, port_st = ref_srv.stats(), port_srv.stats()
    for key in ("completed", "batches", "result_cache_hits",
                "mean_batch_occupancy", "pad_waste_frac"):
        assert port_st[key] == ref_st[key], key
    assert port_st["result_cache"] == ref_st["result_cache"]


def test_obs_records_the_serving_path():
    """With the recorder on, a served burst leaves its dispatch events and
    span tree, and the snapshot shows the server's, the plan cache's and
    the kernel launches' providers; ``plan_health`` equals the
    reference's on the same plan."""
    from repro import obs as robs
    from repro_torch import obs
    rg = RG.barabasi_albert(150, 3, seed=5)
    plan = E.compile_plan(rg, RB.hash_partition(rg, 4), 4, edge_slack=8)
    tplan = TE.plan_from_numpy(plan, device=CPU)
    assert obs.plan_health(tplan) == robs.plan_health(plan)
    srv = TG.GraphServer(TE.Engine(tplan),
                         graph.graph_from_numpy(rg, device=CPU))
    obs.reset()
    obs.enable()
    try:
        srv.serve([TG.QueryRequest("sssp", params={"source": s})
                   for s in (1, 2)] + [TG.QueryRequest("wcc")])
        snap = obs.snapshot()
        events = obs.get().events()
    finally:
        obs.disable()
        obs.reset()
    srv.close()
    by_name = snap["events_by_name"]
    assert by_name["engine.dispatch"] == 2 and by_name["engine.result"] == 2
    assert by_name["serve.admission"] == 3 and by_name["serve.batch"] == 2
    spans = {e["args"]["span_id"] for e in events if e["ph"] == "X"}
    for e in events:
        if e["name"] in ("serve.dispatch", "serve.execute",
                         "serve.materialize"):
            assert e["args"]["parent_id"] in spans
    assert snap["open_spans"] == 0
    assert snap["gauges"]["plan.exchange_per_superstep"] == \
        plan.exchange_volume
    assert "plan_cache" in snap and "launches" in snap
    assert any(k.startswith("serve") and isinstance(v, dict)
               and v.get("completed") == 3 for k, v in snap.items())


# ---------------------------------------------------------------------------
# from_session: serving under mutation, both packages
# ---------------------------------------------------------------------------

def _ref_starts(n: int, k: int) -> np.ndarray:
    """The start vertices the reference's DFEP draws with key 0."""
    return np.asarray(jax.random.choice(jax.random.key(0), n, shape=(k,),
                                        replace=False))


def _sessions(n=200, k=4, seed=3, chunk_size=32, rg=None, **kw):
    """The same streaming session in both packages (the reference's DFEP
    starts) and a ``from_session`` server over each."""
    rg = RG.watts_strogatz(n, 4, 0.2, seed=seed) if rg is None else rg
    cfg = dict(k=k, chunk_size=chunk_size, drift_threshold=1e9)
    ref = RS.StreamSession(rg, RS.StreamConfig(**cfg), key=0)
    port = TS.StreamSession(graph.graph_from_numpy(rg, device=CPU),
                            TS.StreamConfig(**cfg),
                            starts=_ref_starts(rg.n_vertices, k), device=CPU)
    return (ref, port, G.GraphServer.from_session(ref, **kw),
            TG.GraphServer.from_session(port, **kw))


def _same_results(want, got):
    """Both servers' answers: equal values (add programs within ADD_ATOL),
    cache and warm flags, batches, versions and epochs."""
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert b.request.kind == a.request.kind
        assert (b.from_cache, b.warm_start, b.batch_size, b.bucket,
                b.supersteps, b.version, b.epoch, b.error is None) == \
            (a.from_cache, a.warm_start, a.batch_size, a.bucket,
             a.supersteps, a.version, a.epoch, a.error is None), a.row()
        if a.value is None:
            continue
        if a.request.entry.oracle_atol:
            np.testing.assert_allclose(b.value, a.value, rtol=0,
                                       atol=ADD_ATOL)
        else:
            np.testing.assert_array_equal(b.value, a.value)


def _both(Q, reqs):
    """The same request list as each package's QueryRequests."""
    return [Q.QueryRequest(kind, tenant=t, params=dict(p))
            for kind, t, p in reqs]


def test_from_session_plan_swap_on_stream_update():
    ref, port, rsrv, srv = _sessions()
    r0 = srv.serve([TG.QueryRequest("sssp", params={"source": 0})])[0]
    _same_results(rsrv.serve([G.QueryRequest("sssp",
                                             params={"source": 0})]), [r0])
    assert r0.version == 0 and not r0.from_cache
    for sess in (ref, port):
        sess.apply(inserts=np.array([[1, 150], [2, 160]]))
    r1 = srv.serve([TG.QueryRequest("sssp", params={"source": 0})])[0]
    assert r1.version > r0.version and r1.fingerprint != r0.fingerprint
    assert not r1.from_cache, "cache must not serve across a plan swap"
    _check(r1, port.graph())
    assert srv.stats()["plan_buffer_swaps"] >= 1
    assert r1.fingerprint == ref.graph().fingerprint()
    want = rsrv.serve([G.QueryRequest("sssp", params={"source": 0})])
    _same_results(want, [r1])
    srv.close()
    assert len(port._subscribers) == 0     # close unsubscribes
    rsrv.close()


def test_from_session_warm_start_repair_after_insert_only_patch():
    """After an insert-only patch both servers warm-start the repeated
    query from the previous epoch's distances, exact on the post-patch
    graph in no more supersteps; a deletion breaks the lineage."""
    ref, port, rsrv, srv = _sessions(n=240, seed=5)
    steps = [
        (None, [("sssp", "t", {"source": 7}), ("wsssp", "t", {"source": 7})]),
        ({"inserts": np.array([[3, 6], [10, 13]])},
         [("sssp", "t", {"source": 7}), ("wsssp", "t", {"source": 7})]),
        ({"inserts": np.array([[20, 23]])},
         [("sssp", "t", {"source": 7}), ("sssp", "t", {"source": 101})]),
        ("delete", [("sssp", "t", {"source": 7}), ("bfs", "t", {"source": 7})]),
    ]
    out = []
    for update, reqs in steps:
        if update == "delete":
            gu, gv = port.graph().as_numpy()
            update = {"deletes": np.array([[gu[0], gv[0]]])}
        if update is not None:
            ref.apply(**update)
            port.apply(**update)
        want = rsrv.serve(_both(G, reqs))
        got = srv.serve(_both(TG, reqs))
        _same_results(want, got)
        for r in got:
            _check(r, port.graph())
        out.append(got)
    assert not any(r.warm_start for r in out[0])
    for r, c in zip(out[1], out[0]):
        assert r.warm_start and not r.from_cache
        assert r.supersteps <= c.supersteps
    assert out[2][0].warm_start and not out[2][1].warm_start
    assert out[2][0].bucket == out[2][1].bucket, "same dispatch"
    assert not any(r.warm_start for r in out[3])
    assert srv.stats()["warm_started_lanes"] == \
        rsrv.stats()["warm_started_lanes"] == 3
    srv.close()
    rsrv.close()


def test_from_session_inflight_queries_drain_against_captured_buffer():
    ref, port, rsrv, srv = _sessions(buckets=(2,))
    g_old = port.graph()
    outs = []
    for Q, sess, server in ((G, ref, rsrv), (TG, port, srv)):
        for s in (0, 3, 9, 12):
            server.submit(Q.QueryRequest("sssp", params={"source": s}))
        first = server.pump()                  # one bucket=2 batch, old plan
        sess.apply(inserts=np.array([[0, 100], [3, 150], [9, 180]]))
        rest = server.drain()                  # remaining queue, new plan
        outs.append((first, rest))
    (rf, rr), (first, rest) = outs
    _same_results(rf, first)
    _same_results(rr, rest)
    assert [r.request.params["source"] for r in first] == [0, 3]
    g_new = port.graph()
    assert g_old.fingerprint() != g_new.fingerprint()
    for r in first:
        assert r.version == 0
        _check(r, g_old)
    for r in rest:
        assert r.version > 0
        _check(r, g_new)
    srv.close()
    rsrv.close()


def test_from_session_serving_under_mutation_stress():
    """One seeded stream of multi-tenant requests interleaved with
    insert/delete batches (plan swaps while requests are pending) through
    both packages' servers: equal values, cache flags, batches, versions
    and warm-repair counts; every answer exact for the snapshot it was
    served from; no stale cache entry survives a version bump."""
    ref, port, rsrv, srv = _sessions(n=200, buckets=(1, 2, 4))
    snapshots = {port.version: port.graph()}
    port.subscribe(lambda s, event: snapshots.setdefault(s.version,
                                                         s.graph()))
    rng = np.random.default_rng(7)
    n_v = port.graph().n_vertices
    results = []
    for round_ in range(4):
        reqs = [("sssp", f"t{i % 3}", {"source": int(rng.integers(0, n_v))})
                for i in range(5)]
        reqs.append(("wcc", "t0", {}))
        if round_ % 2:
            reqs.append(("pagerank", "t1", {"iters": 8}))
        reqs.append(("sssp", "t2", {"source": 7}))     # repeats: warm repair
        gu, gv = port.graph().as_numpy()
        kill = rng.choice(len(gu), size=4, replace=False)
        ins = rng.integers(0, n_v, size=(6, 2))
        if round_ == 2:
            kill = kill[:0]                            # one insert-only swap
        dels = np.stack([gu[kill], gv[kill]], 1)
        pair = []
        for Q, sess, server in ((G, ref, rsrv), (TG, port, srv)):
            for r in _both(Q, reqs):
                server.submit(r)
            out = server.pump()
            sess.apply(inserts=ins, deletes=dels)
            out += server.drain()
            pair.append(out)
            fps = server.cache.fingerprints()
            assert fps <= {sess.graph().fingerprint()}, \
                "result cache holds entries for a dead fingerprint"
        _same_results(*pair)
        results.extend(pair[1])
    served_versions = {r.version for r in results}
    assert len(served_versions) >= 3, "stress never spanned a plan swap"
    for r in results:
        g_at = snapshots[r.version]
        assert r.fingerprint == g_at.fingerprint()
        _check(r, g_at)
    ref_st, port_st = rsrv.stats(), srv.stats()
    for key in ("completed", "batches", "result_cache_hits",
                "plan_buffer_swaps", "warm_started_lanes"):
        assert port_st[key] == ref_st[key], key
    srv.close()
    rsrv.close()


def test_from_session_epoch_bump_compaction_consistency():
    """A compaction epoch under serving: the post-compaction buffer
    answers correctly and carries the new epoch."""
    rg = RG.watts_strogatz(100, 4, 0.1, seed=1)      # small padding
    ref, port, rsrv, srv = _sessions(k=3, rg=rg)
    want, got = [rsrv.serve([G.QueryRequest("sssp", params={"source": 0})])],\
        [srv.serve([TG.QueryRequest("sssp", params={"source": 0})])]
    assert got[0][0].epoch == 0
    ins = np.random.default_rng(1).integers(0, 100, size=(400, 2))
    stats = port.apply(inserts=ins)
    assert stats == ref.apply(inserts=ins)
    assert stats["recompiles"] >= 1
    want.append(rsrv.serve([G.QueryRequest("sssp", params={"source": 0})]))
    got.append(srv.serve([TG.QueryRequest("sssp", params={"source": 0})]))
    for a, b in zip(want, got):
        _same_results(a, b)
    r1 = got[1][0]
    assert r1.epoch == port.epoch >= 1 and not r1.from_cache
    _check(r1, port.graph())
    srv.close()
    rsrv.close()


def test_from_session_gnn_across_stream_patch():
    """partition -> engine -> stream patch -> serve for gcn_layer and
    kge_score (gspmm programs), through both servers, each answer equal
    to the reference's and to the port's oracle on its snapshot."""
    rg = RG.watts_strogatz(140, 4, 0.1, seed=3)
    ref, port, rsrv, srv = _sessions(rg=rg, cache_entries=0)
    rng = np.random.default_rng(5)
    try:
        for phase in range(2):
            if phase:
                a = rng.integers(0, 140, size=6)
                for sess in (ref, port):
                    sess.apply(inserts=np.stack([a, (a + 7) % 140], 1))
            g = port.graph()
            for name in ("gcn_layer", "kge_score"):
                entry = TE.get_program(name)
                params = {}
                for spec in entry.channel_params:
                    n = {"vertex": g.n_vertices, "edge": g.e_pad,
                         "dense": TE.GCN_F_IN}[spec.channel]
                    params[spec.name] = rng.random((n, spec.features)) \
                        .astype(np.float32)
                reqs = [(name, f"t{i}", params) for i in range(3)]
                want = rsrv.serve(_both(G, reqs))
                got = srv.serve(_both(TG, reqs))
                _same_results(want, got)
                oracle = entry.oracle(g, **params)
                for r in got:
                    np.testing.assert_allclose(r.value, oracle,
                                               atol=entry.oracle_atol)
    finally:
        srv.close()
        rsrv.close()


def test_weighted_and_bfs_flow_through_stream_patch():
    """Weighted SSSP and BFS stay bit-identical to the oracles and to the
    reference across live patches: the patch path keeps the per-half-edge
    weights."""
    rg = RG.watts_strogatz(150, 4, 0.2, seed=4)
    ref, port, rsrv, srv = _sessions(rg=rg)
    rsrv.close()
    srv.close()
    rng = np.random.default_rng(3)
    for _ in range(2):
        gu, gv = port.graph().as_numpy()
        kill = rng.choice(len(gu), size=3, replace=False)
        upd = dict(inserts=rng.integers(0, 150, size=(5, 2)),
                   deletes=np.stack([gu[kill], gv[kill]], 1))
        ref.apply(**upd)
        port.apply(**upd)
        g_now = port.graph()
        rw = port.engine.run(TE.WEIGHTED_SSSP, source=1)
        assert np.array_equal(rw.state.numpy(),
                              alg.reference_weighted_sssp(g_now, 1))
        assert np.array_equal(rw.state.numpy(), np.asarray(
            ref.engine.run(E.WEIGHTED_SSSP, source=1).state))
        rb = port.engine.run(TE.BFS, source=1)
        assert np.array_equal(rb.state.numpy(), alg.reference_bfs(g_now, 1))


def _relation_plane(sg, seed=0):
    """A seeded kge_score relation plane in graph slot order, [e_pad, F]."""
    return np.random.default_rng(seed).random(
        (sg.e_pad, TE.KGE_F)).astype(np.float32)


def _fill(u, v):
    return np.full(TE.KGE_F, (u * 31 + v) % 7 / 7.0, np.float32)


def test_bound_edge_channel_maintained_like_reference():
    """A session-bound edge plane (kge_score's relation) is maintained
    alike in both packages: inserted rows scattered in from ``fill``, rows
    remapped at a compaction, each maintenance a rebind with the same
    content digest; served answers equal across both servers."""
    rg = RG.watts_strogatz(100, 4, 0.1, seed=8)
    ref, port, rsrv, srv = _sessions(k=3, rg=rg, chunk_size=16)
    plane = _relation_plane(port.sg)
    ref.bind_channel("kge_score", "relation", plane, fill=_fill)
    port.bind_channel("kge_score", "relation", plane, fill=_fill)
    rent, tent = E.get_program("kge_score"), TE.get_program("kge_score")
    try:
        rng = np.random.default_rng(9)
        entity = rng.random((100, TE.KGE_F)).astype(np.float32)
        digests = set()
        while port.sg.epoch == 0:
            ins = rng.integers(0, 100, size=(16, 2))
            ref.apply(inserts=ins)
            port.apply(inserts=ins)
            assert tent.bindings["relation"].digest == \
                rent.bindings["relation"].digest
            digests.add(tent.bindings["relation"].digest)
            want = rsrv.serve([G.QueryRequest("kge_score",
                                              params={"entity": entity})])
            got = srv.serve([TG.QueryRequest("kge_score",
                                             params={"entity": entity})])
            _same_results(want, got)
        assert len(digests) > 1 and port.epoch >= 1
        np.testing.assert_array_equal(
            port._channels[("kge_score", "relation")].values,
            ref._channels[("kge_score", "relation")].values)
    finally:
        ref.unbind_channel("kge_score", "relation")
        port.unbind_channel("kge_score", "relation")
        srv.close()
        rsrv.close()
    assert "relation" not in tent.bindings


def test_bind_channel_validation_and_ownership():
    """A failed bind leaves nothing installed; a second live session can
    neither clobber nor release a maintained binding."""
    g = graph.watts_strogatz(80, 4, 0.15, seed=10, device=CPU)
    cfg = TS.StreamConfig(k=2, chunk_size=16, drift_threshold=1e9)
    sess = TS.StreamSession(g, cfg, starts=_ref_starts(80, 2), device=CPU)
    entry = TE.get_program("kge_score")
    with pytest.raises(TE.ChannelError, match="edge slots"):
        sess.bind_channel("kge_score", "relation",
                          np.zeros((sess.sg.e_pad + 64, TE.KGE_F),
                                   np.float32))
    with pytest.raises(TE.ChannelError, match="not 'channel'"):
        sess.bind_channel("sssp", "source", np.zeros(3))
    assert "relation" not in entry.bindings
    sess.bind_channel("kge_score", "relation", _relation_plane(sess.sg))
    sess2 = TS.StreamSession(g, cfg, starts=_ref_starts(80, 2), device=CPU)
    try:
        with pytest.raises(TE.ChannelError, match="another live"):
            sess2.bind_channel("kge_score", "relation",
                               _relation_plane(sess2.sg))
        with pytest.raises(TE.ChannelError, match="only its owner"):
            sess2.unbind_channel("kge_score", "relation")
        assert "relation" in entry.bindings
        sess.unbind_channel("kge_score", "relation")
        sess2.bind_channel("kge_score", "relation",
                           _relation_plane(sess2.sg))
    finally:
        sess2.unbind_channel("kge_score", "relation")
    assert "relation" not in entry.bindings


def test_channel_plane_invalidated_by_swap_fails_soft():
    """A plane valid at submit that a plan swap invalidates before its
    batch is popped (the live-slot high-water mark grows past it) fails
    the request with a typed error result; the server keeps serving."""
    g = graph.watts_strogatz(100, 4, 0.15, seed=12, device=CPU)
    sess = TS.StreamSession(g, TS.StreamConfig(k=3, chunk_size=16,
                                               drift_threshold=1e9),
                            starts=_ref_starts(100, 3), device=CPU)
    srv = TG.GraphServer.from_session(sess)
    entity = np.random.default_rng(1).random((100, TE.KGE_F)) \
        .astype(np.float32)
    plane = _relation_plane(sess.sg)[: sess.plan.edge_slot_hwm]
    rid = srv.submit(TG.QueryRequest("kge_score", params={
        "entity": entity, "relation": plane}))
    sess.apply(inserts=np.array([[0, 50], [1, 60]]))
    assert sess.plan.edge_slot_hwm > len(plane)
    srv.drain()
    r = srv.result(rid)
    assert r is not None and r.value is None
    assert r.error and "EDGE channel" in r.error
    full = _relation_plane(sess.sg)
    ok = srv.serve([TG.QueryRequest("kge_score", params={
        "entity": entity, "relation": full})])[0]
    assert ok.error is None
    np.testing.assert_allclose(
        ok.value, TE.get_program("kge_score").oracle(
            sess.graph(), entity=entity, relation=full), atol=ADD_ATOL)
    srv.close()


def test_gc_session_releases_binding():
    """A session dropped without unbind_channel leaves no stale plane live
    on the process-global registry entry."""
    import gc
    g = graph.watts_strogatz(80, 4, 0.15, seed=13, device=CPU)
    sess = TS.StreamSession(g, TS.StreamConfig(k=2, chunk_size=16,
                                               drift_threshold=1e9),
                            starts=_ref_starts(80, 2), device=CPU)
    sess.bind_channel("kge_score", "relation", _relation_plane(sess.sg))
    entry = TE.get_program("kge_score")
    assert "relation" in entry.bindings
    del sess
    gc.collect()
    assert "relation" not in entry.bindings

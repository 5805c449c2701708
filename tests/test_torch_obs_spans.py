"""The recorder's spans on the profiler's clock and the spans and counters
the server and the superstep loop record (``repro_torch.obs``), on the
CPU: each span is a profiler host op of its name, also when spans close
out of order; a disabled recorder opens no range and moves no counter;
``span.<name>.n`` and ``.s`` stay exact when the ring wraps; answers are
bit-identical with the recorder on and off; ``engine.host_reads`` counts
the loops' reads."""
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import engine as TE
from repro_torch import gserve as TG
from repro_torch import obs
from repro_torch.core import baselines, graph
from repro_torch.obs.recorder import Recorder

CPU = "cpu"


@pytest.fixture(autouse=True)
def _clean_recorder():
    rec = obs.get()
    rec.disable()
    rec.reset()
    yield
    rec.disable()
    rec.reset()


@pytest.fixture(scope="module")
def small():
    g = graph.watts_strogatz(240, 4, 0.2, seed=5, device=CPU)
    plan = TE.compile_plan(g, baselines.hash_partition(g, 4), 4, device=CPU)
    return g, plan


def _host_ops(prof) -> dict:
    """name -> [(start_ns, end_ns)] of the profiler's host events."""
    out: dict = {}
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        out.setdefault(e.name(), []).append((s, s + e.duration_ns()))
    return out


def test_spans_are_profiler_host_ops_also_closed_out_of_order():
    r = Recorder()
    r.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        a = r.begin("t.outer")
        time.sleep(0.002)
        b = r.begin("t.inner")
        time.sleep(0.002)
        r.end(a)                     # closed before the span it holds
        time.sleep(0.002)
        r.end(b)
        with r.span("t.ctx"):
            with r.span("t.ctx_child"):
                torch.ones(4).sum()
    ops = _host_ops(prof)
    for name in ("t.outer", "t.inner", "t.ctx", "t.ctx_child"):
        assert len(ops[name]) == 1, name
    (o0, o1), (i0, i1) = ops["t.outer"][0], ops["t.inner"][0]
    assert o0 < i0 < o1 < i1         # each range ends where its span did
    assert o1 - o0 >= 3_000_000 and i1 - i0 >= 3_000_000
    (c0, c1), (k0, k1) = ops["t.ctx"][0], ops["t.ctx_child"][0]
    assert c0 <= k0 <= k1 <= c1
    assert r.stats()["open_spans"] == 0


def test_disabled_recorder_opens_no_range_and_moves_no_counter():
    r = Recorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sid = r.begin("t.off")
        r.end(sid)
        with r.span("t.off_ctx") as inner:
            assert inner is None
        r.counter("t.count")
    assert sid is None
    assert not {"t.off", "t.off_ctx"} & set(_host_ops(prof))
    assert r.counters() == {} and r.stats()["recorded"] == 0


def test_span_counters_stay_exact_when_the_ring_wraps():
    r = Recorder(capacity=4)
    r.enable()
    durs: dict = {}
    for _ in range(5):
        with r.span("t.parent") as pid:
            with r.span("t.a"):
                time.sleep(0.001)
            late = r.begin("t.b", parent=pid)
            time.sleep(0.001)
            r.end(late)
        for e in r.events():
            if e["ph"] == "X":
                durs[e["args"]["span_id"]] = (e["name"], e["dur"])
    c = r.counters()
    for name in ("t.parent", "t.a", "t.b"):
        got = [d for n, d in durs.values() if n == name]
        assert c[f"span.{name}.n"] == len(got) == 5, name
        assert c[f"span.{name}.s"] == pytest.approx(sum(got) * 1e-6,
                                                    rel=1e-9), name
    assert c["span.t.parent.s"] > c["span.t.a.s"] + c["span.t.b.s"]
    assert r.stats()["overwritten"] > 0


def test_reset_closes_open_ranges():
    r = Recorder()
    r.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.begin("t.left_open")
        r.reset()
    assert len(_host_ops(prof)["t.left_open"]) == 1
    assert r.stats()["open_spans"] == 0


def _requests():
    return [TG.QueryRequest(p, tenant=f"t{s % 2}", params={"source": s})
            for p in ("sssp", "bfs", "wsssp") for s in (0, 7, 31, 99)] + \
        [TG.QueryRequest("wcc", tenant="t0")]


def _pump_all(server) -> dict:
    out = {}
    for r in _requests():
        server.submit(r)
    while server.pending():
        for qr in server.pump():
            key = (qr.request.kind, qr.request.params.get("source"))
            out[key] = (qr.value, qr.supersteps)
    return out


def test_answers_identical_with_the_recorder_on(small):
    g, plan = small
    off = _pump_all(TG.GraphServer(TE.Engine(plan), g))
    rec = obs.get()
    rec.enable()
    on = _pump_all(TG.GraphServer(TE.Engine(plan), g))
    c = rec.counters()
    assert off.keys() == on.keys()
    for key in off:
        assert np.array_equal(off[key][0], on[key][0]), key
        assert off[key][1] == on[key][1], key
    for name in ("serve.pump", "serve.form", "serve.batch", "serve.probe",
                 "serve.dispatch", "serve.execute", "serve.wait",
                 "serve.copy", "serve.materialize", "engine.run",
                 "engine.superstep", "engine.sweep", "engine.read",
                 "engine.gather"):
        assert c[f"span.{name}.n"] >= 1, name
    assert c["serve.queued"] == len(_requests())
    assert c["serve.queue_s"] > 0
    assert "engine.exchanged" not in c
    assert rec.stats()["open_spans"] == 0


def test_spans_nest_under_the_pump(small):
    g, plan = small
    rec = obs.get()
    rec.enable()
    _pump_all(TG.GraphServer(TE.Engine(plan), g))
    by_id = {e["args"]["span_id"]: e for e in rec.events() if e["ph"] == "X"}

    def parent(e):
        return by_id[e["args"]["parent_id"]]["name"]

    want = {"serve.form": "serve.pump", "serve.batch": "serve.pump",
            "serve.probe": "serve.batch", "serve.dispatch": "serve.batch",
            "serve.execute": "serve.batch", "serve.wait": "serve.execute",
            "serve.copy": "serve.execute", "engine.run": "serve.dispatch",
            "engine.superstep": "engine.run", "engine.gather": "engine.run",
            "engine.sweep": "engine.superstep",
            "engine.read": "engine.superstep"}
    seen = set()
    for e in by_id.values():
        if e["name"] in want:
            assert parent(e) == want[e["name"]], e["name"]
            seen.add(e["name"])
    assert seen == set(want)


@pytest.mark.parametrize("batched", [False, True])
def test_host_reads_count_the_loops_reads(small, batched):
    g, plan = small
    eng = TE.Engine(plan)
    prog = TE.get_program("sssp").program
    rec = obs.get()
    rec.enable()
    if batched:
        res = eng.run_batched(prog, {"source": torch.tensor([0, 5, 77])})
    else:
        res = eng.run(prog, source=5)
    c = rec.counters()
    # a read ends each local sweep and each superstep
    assert c["engine.host_reads"] == (c["span.engine.sweep.n"]
                                      + c["span.engine.superstep.n"])
    assert c["span.engine.read.n"] == c["engine.host_reads"]
    if not batched:
        assert c["engine.host_reads"] == res.local_iters + res.supersteps
    (ev,) = [e for e in rec.events() if e["name"] == "engine.result"]
    assert ev["args"]["supersteps"] == int(torch.as_tensor(
        res.supersteps).max())
    assert ev["args"]["local_iters"] == int(torch.as_tensor(
        res.local_iters).max())
    assert ev["args"]["converged"] is bool(torch.as_tensor(
        res.converged).all())

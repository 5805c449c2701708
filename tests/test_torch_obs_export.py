"""The port's trace exporters, flight recorder and incident report
(``repro_torch.obs.export`` / ``flight`` / ``report``) on the CPU: the
export and flight tests of ``tests/test_obs.py`` over the port's recorder
and server, bounded bundles, a bundle dumped by an armed monitor on a
forced alert, and the report renderer of both packages giving identical
text for one seeded synthetic bundle, one JSONL trace and one Chrome
trace."""
import json

import numpy as np
import pytest

from repro.obs import flight as rflight
from repro.obs import report as rreport
from repro_torch import engine as TE
from repro_torch import gserve as TG
from repro_torch import obs
from repro_torch.core import baselines, graph
from repro_torch.obs import flight, report
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


def _served_server(n=150, k=4, seed=3, **kw):
    g = graph.watts_strogatz(n, 4, 0.2, seed=seed, device=CPU)
    plan = TE.compile_plan(g, baselines.hash_partition(g, k), k, device=CPU)
    return g, TG.GraphServer(TE.Engine(plan), g, **kw)


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def test_export_roundtrip(tmp_path):
    g, srv = _served_server()
    rec = obs.get()
    rec.enable()
    srv.serve([TG.QueryRequest("sssp", tenant="a", params={"source": 1}),
               TG.QueryRequest("wcc", tenant="b")])
    srv.close()
    evs = rec.events()

    jl = tmp_path / "trace.jsonl"
    n = obs.export_jsonl(str(jl))
    lines = [json.loads(x) for x in jl.read_text().splitlines()]
    assert n == len(lines) == len(evs)
    assert [x["name"] for x in lines] == [e["name"] for e in evs]

    ct = tmp_path / "trace_chrome.json"
    n2 = obs.export_chrome_trace(str(ct))
    doc = json.loads(ct.read_text())
    tes = doc["traceEvents"]
    assert n2 == len(tes) == len(evs)
    for te in tes:
        assert {"name", "ph", "ts", "pid", "tid"} <= set(te)
        assert te["ph"] in ("X", "i")
        if te["ph"] == "X":
            assert te["dur"] >= 0
        else:
            assert te["s"] == "t"
    sids = {te["args"]["span_id"] for te in tes if "span_id" in te["args"]}
    for te in tes:
        if "parent_id" in te.get("args", {}):
            assert te["args"]["parent_id"] in sids
    assert "otherData" not in doc
    names = {te["name"] for te in tes}
    assert {"serve.batch", "serve.dispatch", "serve.execute",
            "serve.materialize", "engine.dispatch"} <= names


def test_chrome_export_tolerates_overwritten_parent(tmp_path):
    r = Recorder(capacity=4)
    r.enable()
    with r.span("parent") as pid:
        pass                         # parent's X event lands first...
    sid = r.begin("orphan-child", parent=pid)
    r.end(sid)
    for i in range(3):               # ...and the flood overwrites it
        r.event("filler", i=i)
    assert all(e["name"] != "parent" for e in r.events())
    path = tmp_path / "trace.json"
    n = obs.export_chrome_trace(str(path), recorder=r)
    doc = json.loads(path.read_text())
    assert n == len(doc["traceEvents"]) == 4
    (child,) = [te for te in doc["traceEvents"]
                if te["name"] == "orphan-child"]
    assert "parent_id" not in child["args"]
    assert child["args"]["dangling_parent_id"] == pid
    assert doc["otherData"]["dangling_parents"] == 1
    # the recorder's own ring entry keeps its parent id (copied, not
    # mutated)
    (live,) = [e for e in r.events() if e["name"] == "orphan-child"]
    assert live["args"]["parent_id"] == pid


def test_raising_provider_reported_not_fatal(tmp_path):
    r = Recorder()
    boom_calls = []

    def boom():
        boom_calls.append(1)
        raise RuntimeError("gauge backend gone")

    r.register_provider("boom", boom)
    r.register_provider("fine", lambda: {"ok": 1})
    snap = r.snapshot()              # must not raise
    assert snap["fine"] == {"ok": 1}
    assert snap["boom"] == {"error": "RuntimeError: gauge backend gone"}
    assert boom_calls == [1]
    # a bundle over the degraded recorder still dumps, the error inside
    path = flight.FlightRecorder(str(tmp_path), recorder=r).dump("boom")
    doc = json.loads(path.read_text())
    assert doc["snapshot"]["boom"] == {
        "error": "RuntimeError: gauge backend gone"}
    assert doc[flight.BUNDLE_MARKER] == rflight.BUNDLE_VERSION


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------

def test_flight_bundles_bounded_oldest_deleted(tmp_path):
    with pytest.raises(ValueError, match="max_bundles"):
        flight.FlightRecorder(str(tmp_path), max_bundles=0)
    r = Recorder(capacity=16)
    r.enable()
    fr = flight.FlightRecorder(str(tmp_path / "b"), max_bundles=3,
                               recorder=r)
    assert fr.bundles() == []
    paths = []
    for i in range(7):
        r.event("tick", i=i)
        paths.append(fr.dump(f"reason {i}/x", context={"i": i}))
    kept = fr.bundles()
    assert fr.n_dumped == 7 and len(kept) == 3
    assert kept == paths[-3:]                       # the newest survive
    assert all(not p.exists() for p in paths[:-3])
    doc = json.loads(kept[-1].read_text())
    assert doc["reason"] == "reason 6/x" and doc["context"] == {"i": 6}
    assert "reason-6-x" in kept[-1].name            # filesystem-safe slug
    # each dump leaves its own event in the ring
    dumps = [e for e in r.events() if e["name"] == "obs.flight_dump"]
    assert [e["args"]["seq"] for e in dumps] == sorted(
        e["args"]["seq"] for e in dumps)
    assert set(doc) == {flight.BUNDLE_MARKER, "reason", "created_utc",
                        "seq", "context", "stats", "snapshot", "events"}


def test_armed_monitor_dumps_a_bundle_on_a_forced_alert(tmp_path):
    """A monitor whose latency objective no request can meet fires a burn
    alert after a served burst; the armed flight recorder dumps one bundle
    naming it, the report renders it, and disarming stops the dumps."""
    mon = obs.Monitor([obs.SLOPolicy(name="forced",
                                     latency_objective_s=1e-9,
                                     min_samples=1, fast_window_s=5.0,
                                     slow_window_s=5.0)],
                      eval_interval_s=0.0)
    fr = flight.FlightRecorder(str(tmp_path / "fl"), max_bundles=4)
    disarm = fr.arm(mon)
    obs.enable()
    g, srv = _served_server(monitor=mon)
    srv.serve([TG.QueryRequest("sssp", tenant="a", params={"source": s})
               for s in range(3)])
    (bundle,) = fr.bundles()
    doc = json.loads(bundle.read_text())
    assert doc["reason"] == "alert.burn_rate"
    assert doc["context"]["policy"] == "forced"
    assert doc["context"]["tenant"] == "a"
    text = report.render(report.load(str(bundle)))
    assert "INCIDENT  alert.burn_rate" in text and "forced" in text
    assert text == rreport.render(rreport.load(str(bundle)))
    disarm()
    mon.evaluate()
    assert len(fr.bundles()) == 1
    srv.close()
    mon.close()


# ---------------------------------------------------------------------------
# the report renderer against the reference's
# ---------------------------------------------------------------------------

def _synthetic_bundle(seed=5, n_events=60):
    """A seeded bundle in the reference's schema: three alert kinds, the
    health gauges, counters, spans (one with an overwritten parent) and
    instants."""
    rng = np.random.default_rng(seed)
    events, sid = [], 1
    for i in range(n_events):
        ts = float(i * 1000 + rng.uniform(0, 900))
        if rng.random() < 0.6:
            name = ("serve.batch", "serve.dispatch", "serve.execute")[
                int(rng.integers(3))]
            args = {"span_id": sid, "bucket": int(rng.integers(1, 33))}
            if sid > 1:
                args["parent_id"] = int(rng.integers(1, sid))
            if sid == 3:
                args["parent_id"] = 10_000       # evicted from the ring
            events.append({"name": name, "ph": "X", "ts": ts,
                           "dur": float(rng.uniform(1, 5e4)), "tid": 1,
                           "args": args})
            sid += 1
        else:
            events.append({"name": "engine.result", "ph": "i", "ts": ts,
                           "tid": 1, "args": {
                               "supersteps": int(rng.integers(1, 9)),
                               "note": "x" * int(rng.integers(1, 90))}})
    burn = {"kind": "burn_rate", "policy": "p99", "tenant": "t1",
            "program": "sssp", "objective_s": 0.05,
            "availability_target": 0.99, "burn_fast": 14.2,
            "burn_slow": 6.1, "threshold": 2.0,
            "window": {"fast_s": 5.0, "slow_s": 60.0,
                       "fast": {"n": 12, "bad": 9},
                       "slow": {"n": 120, "bad": 40}}}
    events.append({"name": "obs.alert", "ph": "i", "ts": 1e8, "tid": 1,
                   "args": {"kind": "gauge_drift",
                            "gauge": "stream.replication_factor",
                            "value": 2.5, "baseline": 1.9,
                            "reasons": ["drift 31% > 20%"]}})
    events.append({"name": "obs.alert", "ph": "i", "ts": 1e8 + 1, "tid": 1,
                   "args": {"kind": "retrace_rate", "rate_per_s": 3.0,
                            "max_per_s": 1.0,
                            "window": {"window_s": 10.0, "retraces": 30}}})
    return {
        rflight.BUNDLE_MARKER: rflight.BUNDLE_VERSION,
        "reason": "alert.burn_rate", "created_utc": "2026-01-01T00:00:00",
        "seq": 3, "context": burn,
        "stats": {"since_reset": len(events), "dropped": 2,
                  "overwritten": 5, "open_spans": 0},
        "snapshot": {"gauges": {"stream.replication_factor": 2.5,
                                "plan.exchange_per_superstep": 812},
                     "counters": {"engine.dispatches": 14,
                                  "engine.supersteps": 77},
                     "monitor0": {"active_alerts": [burn]}},
        "events": events}


@pytest.mark.parametrize("tail", [5, 15, 100])
def test_report_renders_the_same_bundle_as_the_reference(tmp_path, tail):
    path = tmp_path / "flight-synthetic.json"
    path.write_text(json.dumps(_synthetic_bundle()))
    text = report.render(report.load(str(path)), tail=tail)
    assert text == rreport.render(rreport.load(str(path)), tail=tail)
    for line in ("INCIDENT  alert.burn_rate", "ALERTS (3)", "HEALTH GAUGES",
                 "COUNTERS", "SPAN LATENCY", "TIMELINE TAIL",
                 "re-parented to root"):
        assert line in text, line


def test_report_renders_the_same_traces_as_the_reference(tmp_path, capsys):
    """The port's JSONL and Chrome traces of one served burst render to
    the reference's text; the CLI prints the same."""
    g, srv = _served_server()
    obs.enable()
    srv.serve([TG.QueryRequest("sssp", tenant="a", params={"source": 1}),
               TG.QueryRequest("pagerank", tenant="b", params={"iters": 3}),
               TG.QueryRequest("wcc", tenant="b")])
    srv.close()
    jl, ct = tmp_path / "trace.jsonl", tmp_path / "trace_chrome.json"
    obs.export_jsonl(str(jl))
    obs.export_chrome_trace(str(ct))
    for path in (jl, ct):
        text = report.render(report.load(str(path)))
        assert text == rreport.render(rreport.load(str(path)))
        assert "serve.dispatch" in text and "SPAN LATENCY" in text
    assert report.main([str(jl), "--tail", "4"]) == 0
    port_out = capsys.readouterr().out
    assert rreport.main([str(jl), "--tail", "4"]) == 0
    assert port_out == capsys.readouterr().out
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"name": "a"}\nnot json\n')
    with pytest.raises(SystemExit, match="bad.jsonl:2"):
        report.load(str(bad))

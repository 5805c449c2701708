"""repro_torch.obs.Monitor and the streaming compaction policies against
the reference on the CPU: the same observations on the same fake clock
give the same alerts (burn rates, rejections, wildcards, gauge drift,
retrace rate), the same stream telemetry and the same ``stats()``; a
served slow tenant fires its alert through ``GraphServer(monitor=...)``;
and ``AdaptiveCompactionPolicy`` makes the reference's decisions on one
burst stream (idle compactions, slack sizing, no forced recompile after
warm-up), with answers exact on every patched plan."""
import numpy as np
import pytest
import torch

import jax

from repro import obs as robs
from repro import stream as RS
from repro.core import graph as RG
from repro.obs.monitor import GaugeWatch as RGaugeWatch
from repro.obs.monitor import Monitor as RMonitor
from repro.obs.monitor import SLOPolicy as RSLOPolicy
from repro_torch import engine as TE
from repro_torch import gserve as TG
from repro_torch import obs as tobs
from repro_torch import stream as TS
from repro_torch.core import algorithms as TA
from repro_torch.core import baselines
from repro_torch.core import graph as TGR

CPU = "cpu"


@pytest.fixture(autouse=True)
def _clean_recorders():
    for obs in (robs, tobs):
        obs.disable()
        obs.reset()
    yield
    for obs in (robs, tobs):
        obs.disable()
        obs.reset()


def _fake_clock():
    t = [0.0]

    def clock():
        return t[0]
    clock.advance = lambda dt: t.__setitem__(0, t[0] + dt)
    return clock


class _Twin:
    """The same monitor in both packages on one fake clock; every call is
    made on both and must return the same."""

    def __init__(self, policies=(), **kw):
        self.clock = _fake_clock()
        self.ref = RMonitor([RSLOPolicy(**p) for p in policies],
                            clock=self.clock, **kw)
        self.port = tobs.Monitor([tobs.SLOPolicy(**p) for p in policies],
                                 clock=self.clock, **kw)

    def __getattr__(self, name):
        def both(*args, **kwargs):
            want = getattr(self.ref, name)(*args, **kwargs)
            got = getattr(self.port, name)(*args, **kwargs)
            assert got == want, name
            return got
        return both

    def gauge(self, name, value):
        robs.get().gauge(name, value)
        tobs.get().gauge(name, value)

    def counter(self, name, delta):
        robs.get().counter(name, delta)
        tobs.get().counter(name, delta)

    def enable(self):
        robs.enable()
        tobs.enable()

    def events(self, name):
        out = []
        for obs in (robs, tobs):
            out.append([{k: v for k, v in e["args"].items()}
                        for e in obs.get().events() if e["name"] == name])
        assert out[1] == out[0], name
        return out[1]


def test_burn_rate_fires_and_clears_on_synthetic_stream():
    mon = _Twin(policies=[dict(
        name="p99-lat", tenant="*", program="sssp",
        latency_objective_s=1e-3, availability_target=0.99,
        fast_window_s=5.0, slow_window_s=30.0, burn_threshold=2.0,
        min_samples=5)])
    mon.enable()
    for _ in range(60):                      # healthy: all under objective
        mon.clock.advance(0.5)
        mon.observe("tA", "sssp", 1e-4)
    assert mon.evaluate() == [] and mon.active_alerts() == []
    for _ in range(60):                      # breach: all over objective
        mon.clock.advance(0.5)
        mon.observe("tA", "sssp", 5e-2)
    fired = mon.evaluate()
    assert len(fired) == 1
    alert = fired[0]
    assert alert["kind"] == "burn_rate" and alert["tenant"] == "tA"
    assert alert["burn_fast"] >= 2.0 and alert["burn_slow"] >= 2.0
    assert mon.active_alerts() == [alert]
    mon.clock.advance(0.5)
    assert mon.evaluate() == []              # edge-triggered
    assert len(mon.events("obs.alert")) == 1
    for _ in range(120):                     # recovery: fast window drains
        mon.clock.advance(0.5)
        mon.observe("tA", "sssp", 1e-4)
    assert mon.evaluate() == [] and mon.active_alerts() == []
    assert len(mon.events("obs.alert_clear")) == 1
    mon.stats()
    mon.close()


def test_rejections_count_as_bad_and_wildcards_name_offender():
    mon = _Twin(policies=[dict(
        name="avail", latency_objective_s=10.0, availability_target=0.9,
        fast_window_s=4.0, slow_window_s=8.0, burn_threshold=1.5,
        min_samples=4)])
    for _ in range(20):
        mon.clock.advance(0.3)
        mon.observe("noisy", "wcc", 0.0, ok=False)
        mon.observe("quiet", "wcc", 1e-4)
    fired = mon.evaluate()
    assert [a["tenant"] for a in fired] == ["noisy"]
    assert fired[0]["window"]["fast"]["n_fail"] > 0
    mon.close()


def test_gauge_watch_ceiling_and_drift():
    mon = _Twin()
    mon.ref.watch_gauge(RGaugeWatch(gauge="stream.replication_factor",
                                    ceiling=4.0, max_rel_increase=0.10))
    mon.port.watch_gauge(tobs.GaugeWatch(gauge="stream.replication_factor",
                                         ceiling=4.0, max_rel_increase=0.10))
    mon.enable()
    mon.gauge("stream.replication_factor", 2.0)     # baseline
    assert mon.evaluate() == []
    mon.gauge("stream.replication_factor", 2.5)     # +25% drift
    fired = mon.evaluate()
    assert len(fired) == 1 and fired[0]["kind"] == "gauge_drift"
    assert "drifted" in fired[0]["reasons"][0]
    mon.gauge("stream.replication_factor", 4.5)     # still breached
    assert mon.evaluate() == [] and len(mon.active_alerts()) == 1
    mon.gauge("stream.replication_factor", 2.05)    # back within bounds
    assert mon.evaluate() == [] and mon.active_alerts() == []
    with pytest.raises(ValueError, match="at least one bound"):
        tobs.GaugeWatch(gauge="x")
    mon.close()


def test_retrace_rate_watcher():
    mon = _Twin()
    mon.watch_retrace_rate(max_per_s=0.5, window_s=10.0)
    mon.enable()
    assert mon.evaluate() == []
    for _ in range(5):
        mon.clock.advance(1.0)
        mon.counter("engine.retraces", 2)          # 2/s: a retrace storm
        mon.evaluate()
    active = mon.active_alerts()
    assert len(active) == 1 and active[0]["kind"] == "retrace_rate"
    assert active[0]["rate_per_s"] > 0.5
    mon.close()


def test_stream_telemetry_window():
    mon = _Twin(telemetry_window_s=10.0)
    for i, (n, ins) in enumerate([(100, 40), (300, 250), (50, 0)]):
        mon.clock.advance(2.0)
        mon.observe_update_batch(n, ins, 0.01 * i)
    assert mon.update_rate() == pytest.approx(450 / 4.0)
    assert mon.slack_burn_rate() == pytest.approx(290 / 4.0)
    assert mon.peak_batch_slack() == 250
    mon.clock.advance(30.0)                          # everything expires
    assert mon.peak_batch_slack() == 0 and mon.update_rate() == 0.0
    mon.stats()
    mon.close()


@pytest.mark.parametrize("bad", [
    dict(availability_target=1.0), dict(latency_objective_s=0.0),
    dict(fast_window_s=10.0, slow_window_s=5.0), dict(burn_threshold=0.0),
    dict(min_samples=0)])
def test_slo_policy_validation_matches_reference(bad):
    with pytest.raises(ValueError) as want:
        RSLOPolicy(name="p", **bad)
    with pytest.raises(ValueError) as got:
        tobs.SLOPolicy(name="p", **bad)
    assert str(got.value) == str(want.value)


def test_served_slow_tenant_fires_alert():
    """A served workload with one slow tenant raises an ``obs.alert``
    burn-rate event naming that tenant, and only that one."""
    g = TGR.watts_strogatz(150, 4, 0.2, seed=3, device=CPU)
    plan = TE.compile_plan(g, baselines.hash_partition(g, 4), 4, device=CPU)
    mon = tobs.Monitor(policies=[
        tobs.SLOPolicy(name="slo-slow", tenant="t-slow",
                       latency_objective_s=1e-9, fast_window_s=5.0,
                       slow_window_s=20.0, min_samples=3),
        tobs.SLOPolicy(name="slo-fast", tenant="t-fast",
                       latency_objective_s=60.0, fast_window_s=5.0,
                       slow_window_s=20.0, min_samples=3),
    ], eval_interval_s=0.0)
    srv = TG.GraphServer(TE.Engine(plan), g, cache_entries=0, monitor=mon)
    tobs.enable()
    srv.serve([TG.QueryRequest("sssp", tenant=t, params={"source": i})
               for i, t in enumerate(["t-slow", "t-fast"] * 6)])
    alerts = mon.active_alerts()
    assert [a["tenant"] for a in alerts] == ["t-slow"]
    assert alerts[0]["policy"] == "slo-slow"
    assert any(e["name"] == "obs.alert" for e in tobs.get().events())
    assert any(k.startswith("monitor") for k in tobs.snapshot())
    srv.close()
    mon.close()


def test_monitor_not_fed_when_recorder_disabled():
    g = TGR.watts_strogatz(150, 4, 0.2, seed=3, device=CPU)
    plan = TE.compile_plan(g, baselines.hash_partition(g, 4), 4, device=CPU)
    mon = tobs.Monitor()
    srv = TG.GraphServer(TE.Engine(plan), g, cache_entries=0, monitor=mon)
    srv.serve([TG.QueryRequest("sssp", tenant="a", params={"source": 1})])
    assert mon._series == {}
    srv.close()
    mon.close()


# ---------------------------------------------------------------------------
# compaction policies
# ---------------------------------------------------------------------------

def _starts(n, k, key=0):
    return np.asarray(jax.random.choice(jax.random.key(key), n, shape=(k,),
                                        replace=False))


def _burst(n_v, n, seed):
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n_v, size=(n, 2))
    return e[e[:, 0] != e[:, 1]]


def test_adaptive_policy_decisions_match_reference():
    """One scripted burst/idle stream through both packages' adaptive
    sessions (and reactive twins): the same idle compactions, forced
    recompiles, recommended slack and plans after every step; queries
    exact on every patched plan; no forced recompile after warm-up, while
    the reactive twin is forced mid-burst."""
    g = RG.watts_strogatz(220, 4, 0.2, seed=5)
    cfg = dict(k=4, chunk_size=64, drift_threshold=1e9)
    clock = _fake_clock()
    rpol = RS.AdaptiveCompactionPolicy(RMonitor(clock=clock),
                                       headroom_batches=3.0)
    tpol = TS.AdaptiveCompactionPolicy(tobs.Monitor(clock=clock),
                                       headroom_batches=3.0)
    tg = TGR.graph_from_numpy(g, device=CPU)
    ref = RS.StreamSession(g, RS.StreamConfig(**cfg), key=0, policy=rpol)
    port = TS.StreamSession(tg, TS.StreamConfig(**cfg),
                            starts=_starts(220, 4), policy=tpol, device=CPU)
    reactive = TS.StreamSession(tg, TS.StreamConfig(**cfg),
                                starts=_starts(220, 4), device=CPU)
    assert tpol.recommend_slack(port) == rpol.recommend_slack(ref) \
        == (None, None)

    def same():
        np.testing.assert_array_equal(port.owner, ref.owner)
        for name in ("epoch", "version", "n_patches", "n_recompiles",
                     "n_forced_recompiles", "n_idle_compactions"):
            assert getattr(port, name) == getattr(ref, name), name
        assert tpol.recommend_slack(port) == rpol.recommend_slack(ref)
        assert tpol.should_compact(port) == rpol.should_compact(ref)
        assert (port.plan.e_max, port.plan.v_max) == (ref.plan.e_max,
                                                      ref.plan.v_max)

    burst = _burst(g.n_vertices, 150, 90)
    ref.apply(inserts=burst)
    port.apply(inserts=burst)
    same()
    clock.advance(1.0)
    assert port.idle_tick() and ref.idle_tick()
    assert port.n_idle_compactions == 1
    same()
    forced0 = port.n_forced_recompiles
    for wave in range(4):
        burst = _burst(g.n_vertices, 150, 91 + wave)
        ref.apply(inserts=burst)
        port.apply(inserts=burst)
        reactive.apply(inserts=burst)
        same()
        assert torch.equal(TE.engine_sssp(port.engine, 0).state,
                           TA.reference_sssp(port.graph(), 0)[0])
        clock.advance(1.0)
        assert port.idle_tick() == ref.idle_tick()
        same()
    assert port.n_forced_recompiles == forced0
    assert reactive.n_forced_recompiles >= 1
    rpol.close()
    tpol.close()


def test_adaptive_policy_sizes_slack_from_observed_peak():
    mon = tobs.Monitor(clock=_fake_clock())
    policy = TS.AdaptiveCompactionPolicy(mon, headroom_batches=2.0)
    g = TGR.watts_strogatz(150, 4, 0.2, seed=1, device=CPU)
    sess = TS.StreamSession(g, TS.StreamConfig(k=4, chunk_size=32,
                                               drift_threshold=1e9),
                            starts=_starts(150, 4), policy=policy,
                            device=CPU)
    assert policy.recommend_slack(sess) == (None, None)
    policy.on_apply(sess, 500, 500, 0.1)
    assert policy.recommend_slack(sess) == (1000, None)
    sess._recompile(reason="idle")
    assert tobs.plan_health(sess.plan)["min_free_edge_slots"] >= 2 * 1000
    assert sess.n_forced_recompiles == 0
    with pytest.raises(ValueError):
        TS.AdaptiveCompactionPolicy(mon, headroom_batches=0)
    mon.close()


def test_reactive_policy_is_default_and_inert():
    g = TGR.watts_strogatz(120, 4, 0.2, seed=2, device=CPU)
    sess = TS.StreamSession(g, TS.StreamConfig(k=3, chunk_size=32,
                                               drift_threshold=1e9),
                            starts=_starts(120, 3), device=CPU)
    assert isinstance(sess.policy, TS.ReactiveCompactionPolicy)
    sess.apply(inserts=_burst(g.n_vertices, 40, 1))
    assert sess.idle_tick() is False
    assert sess.n_idle_compactions == 0

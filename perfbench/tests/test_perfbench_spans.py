"""The per-layer metrics that read the program's spans and counters, on
the CPU: a traced serving run on the cut data reports them; the trace
names an idle gap by the innermost program span over it, where no torch
op runs inside that span; a run whose program records no such span or
counter (as before the program recorded them) reads None, never
raises."""
from __future__ import annotations

import time

import pytest

from perfbench import harness, tracing
from perfbench.record import Run
from perfbench.tests import tiny

REPO = tiny.REPO
SERVING = {"driver": "closed_loop"}
NEW = ("queue_wait_ms.serve", "result_copy_ms.serve",
       "host_reads_per_batch.serve")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with tiny.one_thread():
        yield


def _read(name, run):
    return harness.reader(REPO, name)(run)


def _run(counters=None, profile=None, traffic=SERVING) -> Run:
    return Run(cell="c", config={}, traffic=traffic, seed=1, seconds=1.0,
               trace=True, counters=counters or {}, profile=profile)


def test_traced_serving_run_reports_the_counter_metrics(tmp_path):
    root = tiny.make_root(tmp_path)
    out = harness.execute(root, "ba317k-k16.sssp-lanes", 2**31 + 29, 0.2,
                          True, "cpu", time.perf_counter())
    assert out["correct"] is True
    got = out["metrics"]
    for name in NEW:
        assert got[name]["value"] > 0, name
    # two reads at least a batch: a sweep's and the superstep's
    assert got["host_reads_per_batch.serve"]["value"] >= 2


def _ns(ms: float) -> int:
    return int(ms * 1e6)


def test_gaps_are_named_by_the_innermost_program_span():
    """Host ops as the profiler keeps them: the benchmark's span around a
    pump, the program's spans nested in it, a torch op in a sweep, and
    the benchmark's own span between pumps."""
    host = [(_ns(0), _ns(100), "bench.pump"),
            (_ns(1), _ns(99), "serve.pump"),
            (_ns(2), _ns(90), "serve.batch"),
            (_ns(3), _ns(80), "engine.run"),
            (_ns(10), _ns(40), "engine.sweep"),
            (_ns(20), _ns(30), "aten::index"),
            (_ns(40), _ns(50), "engine.read"),
            (_ns(85), _ns(89), "serve.copy"),
            (_ns(100), _ns(110), "bench.submit")]
    gaps = [(_ns(24), _ns(26)),      # under a torch op in a sweep
            (_ns(44), _ns(48)),      # in a read
            (_ns(86), _ns(88)),      # in the result copy
            (_ns(91), _ns(95)),      # the server's own
            (_ns(102), _ns(108))]    # the benchmark's only
    named = tracing._name_gaps(list(gaps), list(host))
    assert named == pytest.approx({"aten::index": 0.002,
                                   "engine.read": 0.004,
                                   "serve.copy": 0.002,
                                   "serve.pump": 0.004,
                                   "bench.submit": 0.006})
    # the benchmark's span around the pump names no gap under the program
    assert "bench.pump" not in named


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_spans_reads_none(name):
    prof = tracing.TraceSummary(window_s=1.0, busy_s=0.7, device_ops={},
                                idle_by_host={"bench.pump": 0.3})
    # a recorder with the engine's older counters only
    older = {"engine.dispatches": 4, "engine.supersteps": 21}
    assert _read(name, _run(older, prof)) is None
    assert _read(name, _run()) is None
    assert _read(name, _run(older, prof, {"driver": "partitions"})) is None


def test_counter_metrics_read_their_ratios():
    c = {"serve.queue_s": 1.5, "serve.queued": 30,
         "span.serve.copy.s": 0.08, "span.serve.copy.n": 4,
         "engine.host_reads": 90, "engine.dispatches": 4}
    run = _run(c)
    assert _read("queue_wait_ms.serve", run) == pytest.approx(50.0)
    assert _read("result_copy_ms.serve", run) == pytest.approx(20.0)
    assert _read("host_reads_per_batch.serve", run) == pytest.approx(22.5)

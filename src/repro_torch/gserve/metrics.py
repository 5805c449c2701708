"""Serving metrics: latency percentiles, throughput, batching efficiency.

A copy of ``repro.gserve.metrics`` over the port's plan cache and
histograms.

One ``ServeMetrics`` per ``GraphServer``.  Each completed request records
its end-to-end latency (submit -> result materialised on host), the
micro-batch it rode in, and whether the epoch-keyed result cache answered
it.  ``snapshot()`` folds in the engine plan cache's hit/miss/eviction
counters (engine.plan.plan_cache_stats) so one record shows the caching
hierarchy: result cache (per query) -> plan cache (per graph content).
The ``GraphServer`` registers ``snapshot()`` as an ``obs`` provider, so
``obs.snapshot()`` shows the same record alongside the plan-cache and
kernel-launch providers.

Latency storage: a mergeable log-bucketed ``LogHistogram`` plus a
``WindowedHistogram`` ring — fixed memory however long the server lives
(the old unbounded ``latencies`` list leaked one float per request), and
``snapshot()`` never sorts.  Percentiles are exact to one log-bucket
width (±3.7% at 32 buckets/decade) with the tails clamped to the exact
observed min/max.  ``snapshot()`` also reports a ``windowed`` sub-dict
(trailing ~10s p50/p95/p99 + rate).

Clock discipline: every latency/qps interval here is measured with
``time.perf_counter()`` — a monotonic clock.  The wall clock
(``time.time``) steps under NTP adjustment, which can manufacture
negative latencies or skew qps.
"""
from __future__ import annotations

import time

import numpy as np

from ..engine.plan import plan_cache_stats
from ..obs.histogram import LogHistogram, WindowedHistogram

# Trailing window reported in snapshot()["windowed"]: long enough to be
# stable at bench qps, short enough to reflect "now" during an incident.
SNAPSHOT_WINDOW_S = 10.0

# Process-lifetime execute-span totals across every server ever created —
# a caller prints the delta over a run next to wall-clock, the same way
# recorder events are attributed from lifetime counts.  The
# windowed ring gives the same spend over a trailing window, so a live
# summary can show "device time now" next to the monotone total.
_EXEC_TOTALS = {"device_s": 0.0, "executes": 0}
_EXEC_WINDOW = WindowedHistogram(slot_s=0.5, slots=60)
_EXEC_T0 = time.perf_counter()


def exec_totals() -> dict:
    """Monotone process-wide device-time spend (a copy), plus the
    trailing-window view of the same execute spans under ``"windowed"``."""
    d = dict(_EXEC_TOTALS)
    d["windowed"] = _EXEC_WINDOW.stats(SNAPSHOT_WINDOW_S,
                                       time.perf_counter() - _EXEC_T0)
    return d


def percentile(xs: list[float], q: float) -> float:
    if not xs:
        return 0.0
    return float(np.percentile(np.asarray(xs, np.float64), q))


class ServeMetrics:
    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.latency_hist = LogHistogram()
        self.latency_window = WindowedHistogram(slot_s=0.5, slots=60)
        self.n_completed = 0
        self.n_rejected = 0
        self.n_rejected_fair_share = 0  # subset of rejections: tenant cap
        self.n_cache_hits = 0
        self.n_batches = 0
        self.n_lanes_dispatched = 0    # padded lanes (bucket sizes summed)
        self.n_lanes_used = 0          # deduped real parameters
        self.n_lanes_warm = 0          # lanes warm-started from a prior epoch
        self.n_requests_batched = 0    # requests answered by engine runs
        self.n_swaps = 0               # plan-buffer swaps observed
        self.device_time_s = 0.0       # summed execute-span durations
        self.n_executes = 0
        self.t0 = time.perf_counter()

    # -- recording (called by the server) -----------------------------------
    def record_result(self, latency_s: float, from_cache: bool) -> None:
        v = float(latency_s)
        self.latency_hist.record(v)
        self.latency_window.record(v, now=time.perf_counter() - self.t0)
        self.n_completed += 1
        if from_cache:
            self.n_cache_hits += 1

    def record_batch(self, n_requests: int, n_lanes: int, bucket: int,
                     warm_lanes: int = 0) -> None:
        self.n_batches += 1
        self.n_requests_batched += n_requests
        self.n_lanes_used += n_lanes
        self.n_lanes_dispatched += bucket
        self.n_lanes_warm += warm_lanes

    def record_rejection(self, fair_share: bool = False) -> None:
        self.n_rejected += 1
        if fair_share:
            self.n_rejected_fair_share += 1

    def record_swap(self) -> None:
        self.n_swaps += 1

    def record_execute(self, dt_s: float) -> None:
        """One completed execute span: device sync wall time."""
        v = float(dt_s)
        self.device_time_s += v
        self.n_executes += 1
        _EXEC_TOTALS["device_s"] += v
        _EXEC_TOTALS["executes"] += 1
        _EXEC_WINDOW.record(v, now=time.perf_counter() - _EXEC_T0)

    # -- reporting -----------------------------------------------------------
    def snapshot(self, result_cache_stats: dict | None = None) -> dict:
        wall = max(time.perf_counter() - self.t0, 1e-9)
        occ = (self.n_requests_batched / self.n_batches
               if self.n_batches else 0.0)
        pad_waste = (1.0 - self.n_lanes_used / self.n_lanes_dispatched
                     if self.n_lanes_dispatched else 0.0)
        h = self.latency_hist
        win = self.latency_window.stats(SNAPSHOT_WINDOW_S,
                                        time.perf_counter() - self.t0)
        return {
            "completed": self.n_completed,
            "rejected": self.n_rejected,
            "rejected_fair_share": self.n_rejected_fair_share,
            "warm_started_lanes": self.n_lanes_warm,
            "qps": round(self.n_completed / wall, 2),
            "latency_p50_s": round(h.percentile(50), 6),
            "latency_p95_s": round(h.percentile(95), 6),
            "latency_p99_s": round(h.percentile(99), 6),
            "latency_mean_s": round(h.mean, 6),
            "windowed": {
                "window_s": win["window_s"],
                "n": win["n"],
                "rate_per_s": win["rate_per_s"],
                "p50_s": round(win["p50"], 6),
                "p95_s": round(win["p95"], 6),
                "p99_s": round(win["p99"], 6),
            },
            "batches": self.n_batches,
            "device_time_s": round(self.device_time_s, 6),
            "executes": self.n_executes,
            "mean_batch_occupancy": round(occ, 3),
            "pad_waste_frac": round(pad_waste, 4),
            "result_cache_hits": self.n_cache_hits,
            "plan_buffer_swaps": self.n_swaps,
            "result_cache": result_cache_stats or {},
            "plan_cache": plan_cache_stats(),
        }

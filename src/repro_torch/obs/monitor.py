"""SLO burn-rate monitoring + health-drift watchers: the flight *control*.

A copy of ``repro.obs.monitor`` (stdlib only, over the port's recorder
and histograms), kept in the port so that ``repro_torch`` imports nothing
of the JAX package. A ``Monitor`` holds three kinds of declarative watch:

  * **SLO policies** (``SLOPolicy``): per tenant x program (``"*"``
    wildcards), a latency objective + availability target evaluated as
    *multi-window burn rates* over windowed histograms.  A request is
    *bad* when it failed (rejected/errored) or ran slower than the
    objective; the burn rate is ``bad_fraction / (1 - availability
    target)`` — how many times faster than sustainable the error budget
    is burning.  An alert fires only when BOTH the fast and the slow
    window burn above threshold (the standard multi-window guard: the
    slow window proves the breach is real, the fast window proves it is
    *still happening*), and clears when the fast window recovers.
  * **gauge watchers** (``GaugeWatch``): absolute ceiling/floor or
    relative-drift bounds on any recorder gauge — replication factor,
    balance NSTDEV, remaining slack from ``obs/health.py`` (the axes the
    paper judges a partitioning on, arXiv 1403.6270 §V-A).
  * **retrace-rate watcher**: the ``engine.retraces`` counter turned into
    a rate. The port traces nothing (its loops are eager), so nothing of
    the port raises that counter; the watcher reads whatever a caller
    counts under the name.

Breaches emit first-class ``obs.alert`` events (clears emit
``obs.alert_clear``) with the offending window attached, flip the alert's
entry in ``active_alerts()``, and invoke ``on_alert`` callbacks.

The monitor also aggregates **stream telemetry** (``observe_update_batch``:
update rate, slack burn) that the adaptive ``CompactionPolicy`` in
``repro_torch.stream`` consumes to schedule proactive compaction and size
slack — closing the loop from observation back into control.

Clock discipline: all timing is monotonic.  ``clock`` is injectable (tests
drive a fake clock); nothing here reads the wall clock.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import itertools
import time
from collections import deque
from typing import Callable

from .histogram import WindowedHistogram
from .recorder import get as _get_recorder

_MONITOR_IDS = itertools.count()     # obs provider names: monitor0, ...


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """One declarative service-level objective for tenant x program.

    ``tenant`` / ``program`` are ``fnmatch`` patterns (``"*"`` matches
    all); a wildcard policy is evaluated per concrete observed series, so
    the alert always names the actual offender.
    """
    name: str
    tenant: str = "*"
    program: str = "*"
    latency_objective_s: float = 0.1      # slower than this is "bad"
    availability_target: float = 0.99     # good-request fraction objective
    fast_window_s: float = 5.0
    slow_window_s: float = 60.0
    burn_threshold: float = 2.0           # x sustainable budget burn
    min_samples: int = 5                  # per window, below which: no verdict

    def __post_init__(self):
        if not (0.0 < self.availability_target < 1.0):
            raise ValueError(
                f"SLO {self.name!r}: availability_target must be in (0, 1)")
        if self.latency_objective_s <= 0:
            raise ValueError(
                f"SLO {self.name!r}: latency_objective_s must be > 0")
        if not (0 < self.fast_window_s <= self.slow_window_s):
            raise ValueError(
                f"SLO {self.name!r}: need 0 < fast_window_s <= slow_window_s")
        if self.burn_threshold <= 0 or self.min_samples < 1:
            raise ValueError(
                f"SLO {self.name!r}: burn_threshold > 0, min_samples >= 1")


@dataclasses.dataclass(frozen=True)
class GaugeWatch:
    """Bounds on one recorder gauge (e.g. ``stream.replication_factor``).

    ``max_rel_increase`` is drift: the baseline is the gauge's value the
    first time the watcher sees it, and the alert fires when the value
    exceeds ``baseline * (1 + max_rel_increase)``.
    """
    gauge: str
    ceiling: float | None = None
    floor: float | None = None
    max_rel_increase: float | None = None

    def __post_init__(self):
        if self.ceiling is None and self.floor is None \
                and self.max_rel_increase is None:
            raise ValueError(
                f"GaugeWatch({self.gauge!r}): needs at least one bound")


class Monitor:
    """Evaluates SLO policies and health watchers over live telemetry.

    Feed it observations (``observe`` per served request — the
    ``GraphServer`` does this when constructed with ``monitor=``;
    ``observe_update_batch`` per stream apply — the adaptive compaction
    policy does), then ``evaluate()`` (or the rate-limited
    ``maybe_evaluate()``) to fire/clear alerts.  Registered as an
    ``obs`` snapshot provider, so ``obs.snapshot()`` shows live windowed
    percentiles and the active alert set next to the cache hierarchy.
    """

    def __init__(self, policies: tuple | list = (), *,
                 clock: Callable[[], float] = time.perf_counter,
                 slot_s: float = 1.0, slots: int = 120,
                 eval_interval_s: float = 0.25,
                 telemetry_window_s: float = 120.0):
        self.policies = tuple(policies)
        self._clock = clock
        self._slot_s = float(slot_s)
        self._slots = int(slots)
        self.eval_interval_s = float(eval_interval_s)
        self.telemetry_window_s = float(telemetry_window_s)
        self._series: dict[tuple[str, str], WindowedHistogram] = {}
        self._gauge_watches: list[GaugeWatch] = []
        self._gauge_baselines: dict[str, float] = {}
        self._retrace_watch: tuple[float, float] | None = None
        self._retrace_marks: deque[tuple[float, float]] = deque(maxlen=4096)
        self._updates: deque[tuple[float, int, int]] = deque(maxlen=4096)
        self._active: dict[tuple, dict] = {}
        self._last_eval = -float("inf")
        self.n_evaluations = 0
        self.n_alerts_fired = 0
        self.on_alert: list[Callable[[dict], None]] = []
        self._unregister = _get_recorder().register_provider(
            f"monitor{next(_MONITOR_IDS)}", self.stats)

    def close(self) -> None:
        self._unregister()

    # -- observations --------------------------------------------------------
    def _now(self, now: float | None) -> float:
        return self._clock() if now is None else float(now)

    def observe(self, tenant: str, program: str, latency_s: float,
                ok: bool = True, now: float | None = None) -> None:
        """One served (or shed) request: the SLO policies' raw material."""
        key = (str(tenant), str(program))
        series = self._series.get(key)
        if series is None:
            series = self._series[key] = WindowedHistogram(
                slot_s=self._slot_s, slots=self._slots)
        series.record(float(latency_s), ok=ok, now=self._now(now))

    def observe_update_batch(self, n_updates: int, slack_used: int,
                             dt_s: float = 0.0,
                             now: float | None = None) -> None:
        """One stream ``apply()``: feeds the update-rate / slack-burn
        telemetry the adaptive compaction policy sizes slack from.
        ``slack_used`` is the batch's inserted-edge count — the upper
        bound on per-partition slack slots it can have consumed."""
        self._updates.append((self._now(now), int(n_updates),
                              int(slack_used)))

    def _update_window(self, now: float | None = None
                       ) -> tuple[float, int, int, int]:
        """(span_s, n_updates, slack_used, peak_batch_slack) over the
        telemetry window."""
        t = self._now(now)
        lo = t - self.telemetry_window_s
        while self._updates and self._updates[0][0] < lo:
            self._updates.popleft()
        if not self._updates:
            return 0.0, 0, 0, 0
        span = max(t - self._updates[0][0], self._slot_s)
        return (span, sum(u[1] for u in self._updates),
                sum(u[2] for u in self._updates),
                max(u[2] for u in self._updates))

    def update_rate(self, now: float | None = None) -> float:
        """Observed edge updates per second over the telemetry window."""
        span, n, _, _ = self._update_window(now)
        return n / span if span > 0 else 0.0

    def slack_burn_rate(self, now: float | None = None) -> float:
        """Observed slack slots consumed per second (insert pressure)."""
        span, _, used, _ = self._update_window(now)
        return used / span if span > 0 else 0.0

    def peak_batch_slack(self, now: float | None = None) -> int:
        """Largest single-apply slack consumption in the window — the
        burst magnitude proactive headroom must absorb."""
        return self._update_window(now)[3]

    # -- watcher registration ------------------------------------------------
    def watch_gauge(self, watch: GaugeWatch) -> None:
        self._gauge_watches.append(watch)

    def watch_retrace_rate(self, max_per_s: float,
                           window_s: float = 30.0) -> None:
        self._retrace_watch = (float(max_per_s), float(window_s))

    # -- evaluation ----------------------------------------------------------
    def _burn(self, policy: SLOPolicy, series: WindowedHistogram,
              window_s: float, now: float) -> tuple[float, dict]:
        hist, n_fail = series.window(window_s, now)
        n = hist.n
        if n == 0:
            return 0.0, {"n": 0, "bad": 0}
        bad = n_fail + hist.count_above(policy.latency_objective_s)
        burn = (bad / n) / (1.0 - policy.availability_target)
        return burn, {"n": n, "bad": bad, "n_fail": n_fail,
                      "p50_s": hist.percentile(50),
                      "p99_s": hist.percentile(99)}

    def _transition(self, key: tuple, breached: bool, alert: dict,
                    fired: list[dict]) -> None:
        """Edge-triggered alert state machine: record + event + callbacks
        on fire, event on clear."""
        rec = _get_recorder()
        if breached and key not in self._active:
            self._active[key] = alert
            self.n_alerts_fired += 1
            rec.event("obs.alert", **alert)
            fired.append(alert)
            for cb in list(self.on_alert):
                cb(alert)
        elif not breached and key in self._active:
            cleared = self._active.pop(key)
            rec.event("obs.alert_clear",
                      kind=cleared["kind"], key=list(key))

    def evaluate(self, now: float | None = None) -> list[dict]:
        """Run every policy + watcher; returns newly fired alerts."""
        t = self._now(now)
        self._last_eval = t
        self.n_evaluations += 1
        fired: list[dict] = []
        # SLO burn rates: wildcard policies evaluate per concrete series
        for p in self.policies:
            for (tenant, program), series in list(self._series.items()):
                if not (fnmatch.fnmatchcase(tenant, p.tenant)
                        and fnmatch.fnmatchcase(program, p.program)):
                    continue
                key = ("burn_rate", p.name, tenant, program)
                burn_fast, wf = self._burn(p, series, p.fast_window_s, t)
                burn_slow, ws = self._burn(p, series, p.slow_window_s, t)
                enough = (wf["n"] >= p.min_samples
                          and ws["n"] >= p.min_samples)
                breached = (enough and burn_fast >= p.burn_threshold
                            and burn_slow >= p.burn_threshold)
                # clear needs only the fast window to recover (or drain)
                still = (key in self._active
                         and burn_fast >= p.burn_threshold and wf["n"] > 0)
                self._transition(key, breached or still, {
                    "kind": "burn_rate", "policy": p.name,
                    "tenant": tenant, "program": program,
                    "objective_s": p.latency_objective_s,
                    "availability_target": p.availability_target,
                    "threshold": p.burn_threshold,
                    "burn_fast": round(burn_fast, 3),
                    "burn_slow": round(burn_slow, 3),
                    "window": {"fast_s": p.fast_window_s,
                               "slow_s": p.slow_window_s,
                               "fast": wf, "slow": ws},
                }, fired)
        # gauge drift
        gauges = _get_recorder().gauges()
        for w in self._gauge_watches:
            value = gauges.get(w.gauge)
            if value is None:
                continue
            base = self._gauge_baselines.setdefault(w.gauge, float(value))
            reasons = []
            if w.ceiling is not None and value > w.ceiling:
                reasons.append(f"value {value:.4g} > ceiling {w.ceiling:.4g}")
            if w.floor is not None and value < w.floor:
                reasons.append(f"value {value:.4g} < floor {w.floor:.4g}")
            if w.max_rel_increase is not None and base > 0 \
                    and value > base * (1.0 + w.max_rel_increase):
                reasons.append(f"value {value:.4g} drifted "
                               f"{value / base - 1.0:+.1%} from baseline "
                               f"{base:.4g} (> +{w.max_rel_increase:.0%})")
            self._transition(("gauge", w.gauge), bool(reasons), {
                "kind": "gauge_drift", "gauge": w.gauge,
                "value": float(value), "baseline": base,
                "reasons": reasons,
                "window": {"gauges": {k: v for k, v in gauges.items()
                                      if k.startswith("stream.")}},
            }, fired)
        # retrace storms
        if self._retrace_watch is not None:
            max_per_s, window_s = self._retrace_watch
            count = float(_get_recorder().counters()
                          .get("engine.retraces", 0))
            self._retrace_marks.append((t, count))
            lo = t - window_s
            while len(self._retrace_marks) > 1 \
                    and self._retrace_marks[1][0] <= lo:
                self._retrace_marks.popleft()
            t0, c0 = self._retrace_marks[0]
            span = max(t - t0, self._slot_s)
            rate = max(count - c0, 0.0) / span
            self._transition(("retrace_rate",), rate > max_per_s, {
                "kind": "retrace_rate", "rate_per_s": round(rate, 3),
                "max_per_s": max_per_s,
                "window": {"window_s": window_s, "retraces": count - c0,
                           "span_s": round(span, 3)},
            }, fired)
        return fired

    def maybe_evaluate(self, now: float | None = None) -> list[dict]:
        """Rate-limited ``evaluate`` for hot paths (the serving drain)."""
        t = self._now(now)
        if t - self._last_eval < self.eval_interval_s:
            return []
        return self.evaluate(t)

    # -- introspection -------------------------------------------------------
    def active_alerts(self) -> list[dict]:
        return list(self._active.values())

    def stats(self) -> dict:
        """Live monitor state — registered as an ``obs`` provider."""
        t = self._now(None)
        return {
            "policies": [p.name for p in self.policies],
            "gauge_watches": [w.gauge for w in self._gauge_watches],
            "evaluations": self.n_evaluations,
            "alerts_fired": self.n_alerts_fired,
            "active_alerts": self.active_alerts(),
            "series": {
                f"{tenant}/{program}": s.stats(60.0, t)
                for (tenant, program), s in self._series.items()},
            "stream_telemetry": {
                "update_rate_per_s": round(self.update_rate(t), 3),
                "slack_burn_per_s": round(self.slack_burn_rate(t), 3),
                "peak_batch_slack": self.peak_batch_slack(t),
            },
        }

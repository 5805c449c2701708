"""Mergeable per-tenant usage ledger: who spent which device resources.

A copy of ``repro.obs.ledger`` (stdlib only, over the port's recorder and
histograms), kept in the port so that ``repro_torch`` imports nothing of
the JAX package; its ``dump()`` schema is the reference's, key for key,
so either package's ``usage`` renders the other's dumps.

``CostLedger`` joins the static per-sweep ``CostModel`` (obs.profile)
with each batch's measured device time: every completed dispatch posts one
``CostSample`` per request into a series keyed tenant × program × graph
× epoch.  Each series keeps a fixed-memory ``LogHistogram`` of
per-request device seconds plus monotone counters (device_s, flops, HBM
bytes, collective bytes, supersteps, requests, dispatched/cached
splits) and a utilization-weighted device-time sum, so "what does
tenant A's pagerank on graph G cost" is one dict lookup, and the whole
ledger stays O(active series) regardless of traffic.

The accounting invariant (held by the tests and ``chip_smoke.py``):
per-tenant device-second totals sum to the server's measured
``device_time_s`` (±1%), and every dispatched request lands in exactly
one series.  Cache hits post zero-device-time samples (``from_cache``)
so request counts still reconcile.

Windowed shares — the admission-control signal — come from per-tenant
``WindowedHistogram`` rings recording device seconds against the
ledger's own monotonic clock: ``tenant_shares(window_s)`` normalizes the
trailing-window sums to fractions.  Ledgers ``merge()`` associatively
(histograms add, counters add) for multi-process roll-ups; windowed
rings are per-process and deliberately not merged.

A process-global ledger (``get_ledger()``) is registered as the
``"ledger"`` snapshot provider, so ``obs.snapshot()`` and every flight
bundle carry the usage breakdown automatically.  Explicit instances
(a per-server ledger under test) can be registered with
``register(ledger)``.  Render either with ``python -m
repro_torch.obs.usage``.
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field

from . import recorder as _rec
from .histogram import LogHistogram, WindowedHistogram

SNAPSHOT_KIND = "cost_ledger"
DEFAULT_WINDOW_S = 60.0


@dataclass(frozen=True)
class CostSample:
    """One request's resolved cost: measured device time × modeled work.

    ``device_s`` is this request's slice of the batch's measured device
    time (an even split across the requests a batch served);
    ``flops``/``hbm_bytes``/``coll_bytes`` come from
    ``CostModel.cost(sweeps)`` split the same way.  ``utilization`` is
    achieved-vs-attainable: the roofline lower bound on the batch's
    device time divided by its measured time, in [0, 1] up to model
    error.  Cache hits post ``from_cache=True`` with zero device time so
    request accounting still balances.
    """

    tenant: str
    program: str
    graph: str
    epoch: int
    device_s: float
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: float = 0.0
    supersteps: int = 0
    n_requests: int = 1
    from_cache: bool = False
    utilization: float = 0.0


@dataclass
class _Series:
    """Monotone accumulators for one tenant × program × graph × epoch."""

    hist: LogHistogram = field(
        default_factory=lambda: LogHistogram(lo=1e-7, hi=1e4))
    device_s: float = 0.0
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: float = 0.0
    supersteps: int = 0
    requests: int = 0
    dispatched: int = 0
    cached: int = 0
    util_s: float = 0.0          # sum(utilization * device_s)

    def post(self, s: CostSample) -> None:
        self.hist.record(s.device_s)
        self.device_s += s.device_s
        self.flops += s.flops
        self.hbm_bytes += s.hbm_bytes
        self.coll_bytes += s.coll_bytes
        self.supersteps += int(s.supersteps)
        self.requests += int(s.n_requests)
        if s.from_cache:
            self.cached += int(s.n_requests)
        else:
            self.dispatched += int(s.n_requests)
        self.util_s += s.utilization * s.device_s

    def merge(self, other: "_Series") -> None:
        self.hist.merge(other.hist)
        self.device_s += other.device_s
        self.flops += other.flops
        self.hbm_bytes += other.hbm_bytes
        self.coll_bytes += other.coll_bytes
        self.supersteps += other.supersteps
        self.requests += other.requests
        self.dispatched += other.dispatched
        self.cached += other.cached
        self.util_s += other.util_s

    def stats(self) -> dict:
        return {
            "device_s": self.device_s, "flops": self.flops,
            "hbm_bytes": self.hbm_bytes, "coll_bytes": self.coll_bytes,
            "supersteps": self.supersteps, "requests": self.requests,
            "dispatched": self.dispatched, "cached": self.cached,
            "utilization": (self.util_s / self.device_s
                            if self.device_s > 0 else 0.0),
            "device_hist": self.hist.stats(),
        }


class CostLedger:
    """Thread-safe mergeable usage ledger with windowed per-tenant shares."""

    def __init__(self, window_s: float = DEFAULT_WINDOW_S):
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._series: dict[tuple[str, str, str, int], _Series] = {}
        self._windows: dict[str, WindowedHistogram] = {}

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    # -- recording -----------------------------------------------------------
    def post(self, sample: CostSample) -> None:
        key = (sample.tenant, sample.program, sample.graph,
               int(sample.epoch))
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = _Series()
            series.post(sample)
            win = self._windows.get(sample.tenant)
            if win is None:
                win = self._windows[sample.tenant] = WindowedHistogram(
                    slot_s=0.5, slots=120, lo=1e-7, hi=1e4)
            win.record(sample.device_s, now=self._now())

    # -- queries -------------------------------------------------------------
    def totals(self) -> dict:
        with self._lock:
            return {
                "series": len(self._series),
                "device_s": sum(s.device_s for s in self._series.values()),
                "flops": sum(s.flops for s in self._series.values()),
                "hbm_bytes": sum(s.hbm_bytes
                                 for s in self._series.values()),
                "coll_bytes": sum(s.coll_bytes
                                  for s in self._series.values()),
                "requests": sum(s.requests for s in self._series.values()),
                "dispatched": sum(s.dispatched
                                  for s in self._series.values()),
                "cached": sum(s.cached for s in self._series.values()),
            }

    def tenant_shares(self, window_s: float | None = None
                      ) -> dict[str, float]:
        """Per-tenant fraction of device time over the trailing
        ``window_s`` seconds (the admission signal); ``None``/``0`` uses
        lifetime totals."""
        with self._lock:
            if window_s:
                now = self._now()
                spent = {t: w.window(float(window_s), now)[0].total
                         for t, w in self._windows.items()}
            else:
                spent = {}
                for (tenant, _, _, _), s in self._series.items():
                    spent[tenant] = spent.get(tenant, 0.0) + s.device_s
        total = sum(spent.values())
        if total <= 0:
            return {t: 0.0 for t in spent}
        return {t: v / total for t, v in spent.items()}

    def snapshot(self) -> dict:
        """Structured record for obs.snapshot()/flight bundles/usage.py."""
        with self._lock:
            series = [
                {"tenant": t, "program": p, "graph": g, "epoch": e,
                 **s.stats()}
                for (t, p, g, e), s in sorted(self._series.items())
            ]
        shares = self.tenant_shares(self.window_s)
        tenants: dict[str, dict] = {}
        for row in series:
            agg = tenants.setdefault(row["tenant"], {
                "device_s": 0.0, "flops": 0.0, "hbm_bytes": 0.0,
                "coll_bytes": 0.0, "requests": 0, "dispatched": 0,
                "cached": 0, "util_s": 0.0})
            for k in ("device_s", "flops", "hbm_bytes", "coll_bytes",
                      "requests", "dispatched", "cached"):
                agg[k] += row[k]
            agg["util_s"] += row["utilization"] * row["device_s"]
        for t, agg in tenants.items():
            util_s = agg.pop("util_s")
            agg["utilization"] = (util_s / agg["device_s"]
                                  if agg["device_s"] > 0 else 0.0)
            agg["window_share"] = shares.get(t, 0.0)
        return {"kind": SNAPSHOT_KIND, "version": 1,
                "window_s": self.window_s, "totals": self.totals(),
                "tenants": tenants, "series": series}

    # -- lifecycle -----------------------------------------------------------
    def merge(self, other: "CostLedger") -> "CostLedger":
        """Fold another ledger's series in place (multi-process roll-up).
        Windowed rings stay local — shares only mean anything against one
        process's clock."""
        with other._lock:
            items = [(k, s) for k, s in other._series.items()]
        with self._lock:
            for key, s in items:
                mine = self._series.get(key)
                if mine is None:
                    mine = self._series[key] = _Series()
                mine.merge(s)
        return self

    def reset(self) -> None:
        with self._lock:
            self._series.clear()
            self._windows.clear()
            self._t0 = time.perf_counter()

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)


_GLOBAL = CostLedger()


def get_ledger() -> CostLedger:
    """The process-global ledger (default sink when gserve has no
    explicit one)."""
    return _GLOBAL


def register(ledger: CostLedger, name: str = "ledger"):
    """Expose a ledger in obs.snapshot() / flight bundles; returns the
    unregister callable."""
    return _rec.get().register_provider(name, ledger.snapshot)


register(_GLOBAL)

"""Mergeable log-bucketed streaming histograms with fixed memory.

A copy of ``repro.obs.histogram`` (stdlib + numpy only), kept in the port
so that ``repro_torch`` imports nothing of the JAX package.

``LogHistogram`` is the aggregation primitive the active observability
layer is built on: latencies (and any other positive quantity spanning
orders of magnitude) are counted into geometrically spaced buckets —
``buckets_per_decade`` per factor of 10 between ``lo`` and ``hi`` — so a
recorded stream of any length costs one fixed int64 array, one increment
per sample, and percentile queries never sort anything.  The price is
resolution: a percentile is exact only up to one log-bucket width
(``width_factor`` = 10^(1/buckets_per_decade), ±3.7% at the default 32
buckets per decade), the resolution ``ServeMetrics`` reports with.

Histograms with the same bucketing **merge associatively** (count arrays
add), so per-slot sub-histograms compose into any window — that is what
``WindowedHistogram`` does: a ring of time-sliced sub-histograms rotated
by a monotonic clock, answering windowed p50/p95/p99, event rates and
failure counts over "the last W seconds" for the burn-rate monitor
without ever growing memory.

Nothing here reads the wall clock: callers pass ``now`` from
``time.perf_counter()`` (or any monotonic source — tests inject a fake
clock), keeping the package's clock discipline.
"""
from __future__ import annotations

import math

import numpy as np


class LogHistogram:
    """Fixed-memory histogram over geometric buckets of a positive value.

    Values below ``lo`` clamp into the first bucket, above ``hi`` into the
    last — nothing is ever dropped, only blurred.  Exact ``min``/``max``
    are tracked on the side so the tails never leave the observed range.
    """

    __slots__ = ("lo", "hi", "buckets_per_decade", "_log_lo", "_scale",
                 "counts", "n", "total", "vmin", "vmax")

    def __init__(self, lo: float = 1e-7, hi: float = 1e4,
                 buckets_per_decade: int = 32):
        if not (0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
        if buckets_per_decade < 1:
            raise ValueError("buckets_per_decade must be >= 1")
        self.lo = float(lo)
        self.hi = float(hi)
        self.buckets_per_decade = int(buckets_per_decade)
        self._log_lo = math.log10(self.lo)
        self._scale = float(buckets_per_decade)
        n_buckets = int(math.ceil(
            (math.log10(self.hi) - self._log_lo) * self._scale)) + 1
        self.counts = np.zeros(n_buckets, np.int64)
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    # -- geometry ------------------------------------------------------------
    @property
    def width_factor(self) -> float:
        """Multiplicative width of one bucket: the resolution contract."""
        return 10.0 ** (1.0 / self.buckets_per_decade)

    def same_buckets(self, other: "LogHistogram") -> bool:
        return (self.lo == other.lo and self.hi == other.hi
                and self.buckets_per_decade == other.buckets_per_decade)

    def _index(self, value: float) -> int:
        if value <= self.lo:
            return 0
        i = int((math.log10(value) - self._log_lo) * self._scale)
        return min(i, len(self.counts) - 1)

    def edge(self, i: int) -> float:
        """Lower edge of bucket ``i``."""
        return 10.0 ** (self._log_lo + i / self._scale)

    # -- recording -----------------------------------------------------------
    def record(self, value: float) -> None:
        v = float(value)
        self.counts[self._index(v)] += 1
        self.n += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def record_many(self, values) -> None:
        vs = np.asarray(values, np.float64).reshape(-1)
        if vs.size == 0:
            return
        idx = np.clip(((np.log10(np.maximum(vs, self.lo)) - self._log_lo)
                       * self._scale).astype(np.int64),
                      0, len(self.counts) - 1)
        np.add.at(self.counts, idx, 1)
        self.n += int(vs.size)
        self.total += float(vs.sum())
        self.vmin = min(self.vmin, float(vs.min()))
        self.vmax = max(self.vmax, float(vs.max()))

    # -- merging (associative + commutative) ---------------------------------
    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """Fold ``other`` into this histogram in place; returns self."""
        if not self.same_buckets(other):
            raise ValueError("cannot merge histograms with different buckets")
        self.counts += other.counts
        self.n += other.n
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        return self

    def copy(self) -> "LogHistogram":
        h = LogHistogram(self.lo, self.hi, self.buckets_per_decade)
        h.counts = self.counts.copy()
        h.n, h.total, h.vmin, h.vmax = self.n, self.total, self.vmin, \
            self.vmax
        return h

    def clear(self) -> None:
        self.counts[:] = 0
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    # -- queries -------------------------------------------------------------
    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def percentile(self, q: float) -> float:
        """Approximate percentile: the geometric midpoint of the bucket
        holding the q-th sample, clamped to the exact observed [min, max]
        — within one log-bucket width of the sorted-array answer."""
        if self.n == 0:
            return 0.0
        target = max(1, int(math.ceil(q / 100.0 * self.n)))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += int(c)
            if cum >= target:
                mid = math.sqrt(self.edge(i) * self.edge(i + 1))
                return float(min(max(mid, self.vmin), self.vmax))
        return float(self.vmax)                    # not reachable

    def count_above(self, threshold: float) -> int:
        """Samples strictly above ``threshold``, at bucket resolution:
        counts whole buckets whose lower edge is >= the threshold's bucket
        upper edge (a value sharing the threshold's bucket counts as NOT
        above — the blur errs toward fewer violations)."""
        if self.n == 0:
            return 0
        i = self._index(float(threshold))
        return int(self.counts[i + 1:].sum())

    def stats(self) -> dict:
        return {"n": self.n, "mean": round(self.mean, 9),
                "min": 0.0 if self.n == 0 else self.vmin,
                "max": 0.0 if self.n == 0 else self.vmax,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99)}


class _Slot:
    """One time slice of a WindowedHistogram."""

    __slots__ = ("hist", "n_fail")

    def __init__(self, lo, hi, bpd):
        self.hist = LogHistogram(lo, hi, bpd)
        self.n_fail = 0

    def clear(self):
        self.hist.clear()
        self.n_fail = 0


class WindowedHistogram:
    """A ring of per-time-slot sub-histograms: windowed percentiles/rates.

    ``slots`` slices of ``slot_s`` seconds each — the longest answerable
    window is ``slots * slot_s``.  Recording advances the ring by the
    caller-supplied monotonic ``now`` (slices that time skipped over are
    zeroed); ``window(W, now)`` merges the slices covering the last ``W``
    seconds into one ``LogHistogram`` plus a failure count, so one ring
    serves every window the multi-window burn-rate monitor asks for.
    """

    def __init__(self, slot_s: float = 1.0, slots: int = 120,
                 lo: float = 1e-7, hi: float = 1e4,
                 buckets_per_decade: int = 32):
        if slot_s <= 0 or slots < 1:
            raise ValueError("need slot_s > 0 and slots >= 1")
        self.slot_s = float(slot_s)
        self.slots = int(slots)
        self._ring = [_Slot(lo, hi, buckets_per_decade)
                      for _ in range(self.slots)]
        self._cur: int | None = None       # absolute slot index of newest
        self._lo, self._hi, self._bpd = lo, hi, buckets_per_decade
        self.lifetime_n = 0
        self.lifetime_fail = 0

    @property
    def max_window_s(self) -> float:
        return self.slot_s * self.slots

    def _advance(self, now: float) -> _Slot:
        idx = int(now // self.slot_s)
        if self._cur is None:
            self._cur = idx
            self._ring[idx % self.slots].clear()
        elif idx > self._cur:
            # zero every slice time skipped over (cap one full revolution)
            for j in range(self._cur + 1,
                           min(idx, self._cur + self.slots) + 1):
                self._ring[j % self.slots].clear()
            self._cur = idx
        # idx < self._cur (a clock running backwards) clamps to the newest
        # slice rather than resurrecting an expired one
        return self._ring[self._cur % self.slots]

    def record(self, value: float, ok: bool = True, now: float = 0.0) -> None:
        """Record one sample at monotonic time ``now``.  ``ok=False`` marks
        a failure (rejection/error) — counted for availability, with the
        value still recorded (0-latency failures land in the lo bucket)."""
        slot = self._advance(float(now))
        slot.hist.record(value)
        if not ok:
            slot.n_fail += 1
            self.lifetime_fail += 1
        self.lifetime_n += 1

    def window(self, window_s: float, now: float
               ) -> tuple[LogHistogram, int]:
        """(merged histogram, failure count) over ``[now - window_s, now]``,
        at slot granularity (a partial oldest slot is included whole)."""
        out = LogHistogram(self._lo, self._hi, self._bpd)
        n_fail = 0
        if self._cur is None:
            return out, 0
        self._advance(float(now))          # expire slices time skipped over
        k = min(self.slots, max(1, int(math.ceil(window_s / self.slot_s))))
        for j in range(self._cur, self._cur - k, -1):
            if j < 0:
                break
            slot = self._ring[j % self.slots]
            out.merge(slot.hist)
            n_fail += slot.n_fail
        return out, n_fail

    def rate(self, window_s: float, now: float) -> float:
        """Events per second over the trailing window."""
        hist, _ = self.window(window_s, now)
        w = min(float(window_s), self.max_window_s)
        return hist.n / w if w > 0 else 0.0

    def stats(self, window_s: float, now: float) -> dict:
        hist, n_fail = self.window(window_s, now)
        out = hist.stats()
        out["window_s"] = min(float(window_s), self.max_window_s)
        out["n_fail"] = n_fail
        out["rate_per_s"] = round(hist.n / out["window_s"], 3) \
            if out["window_s"] > 0 else 0.0
        return out

"""Process-global observability recorder: events, spans, counters, gauges.

A copy of ``repro.obs.recorder`` (stdlib only), kept in the port so that
``repro_torch`` imports nothing of the JAX package.

One ``Recorder`` instance per process (``get()``), shared by every
subsystem — partition plan compilation, the superstep engine, the
streaming session, and the serving layer all record into the same
fixed-size ring buffer, so one exported trace follows a served request
from admission through batch formation, dispatch, device execution and
host materialisation, interleaved with whatever else happened around
it.

Overhead contract
-----------------
The recorder is DISABLED by default.  Every recording method begins with
``if not self._enabled: return`` — one predictable branch, no allocation
inside the recorder.  Hot call sites (per-dispatch, per-request) guard
with ``if rec.enabled:`` before building keyword arguments, so a disabled
recorder costs one attribute read per potential event.  When enabled,
recording one event is a dict build plus a ring-slot assignment — no I/O,
no locks on the record path (CPython list-item assignment is atomic under
the GIL; a racing pair of writers can at worst overwrite one slot, never
corrupt the ring).

Ring buffer
-----------
``capacity`` slots, overwritten oldest-first.  ``stats()["recorded"]`` is
a lifetime monotonic count (survives ``reset()``); ``dropped`` counts
events that have been overwritten since the last reset, and
``overwritten`` is the lifetime monotone overwrite count — the silent-
data-loss meter.

Spans
-----
``begin(name, parent=..., **args) -> span_id`` / ``end(span_id, **extra)``
record a complete-span event (Chrome ``"X"`` phase) at *end* time with its
measured duration.  ``parent`` defaults to the innermost open span on the
current thread (``span()`` context manager maintains that stack), but can
be passed explicitly — the serving layer's software-pipelined drain
interleaves batches, so its child spans carry explicit parent ids.
``args["span_id"]`` / ``args["parent_id"]`` make the tree reconstructable
from an exported trace.

Ambient tags
------------
``with rec.tags(program="sssp", bucket=16): ...`` merges key/values into
every event recorded on the thread inside the block — how an event deep
inside the engine gets attributed to the dispatch (program, bucket shape)
that triggered it without threading arguments through every layer.

Providers
---------
``register_provider(name, fn)`` attaches a live stats source (the serving
metrics, the plan cache, the kernel launch counters).  ``snapshot()`` calls
each one so a single call shows the whole hierarchy: result cache ->
plan cache -> device.  Bound methods are held by weakref —
a garbage-collected server drops out of the snapshot instead of leaking.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
import weakref
from typing import Any, Callable


class Recorder:
    """Fixed-size ring buffer of structured events and spans."""

    def __init__(self, capacity: int = 8192):
        self._capacity = int(capacity)
        self._enabled = False
        self._providers: dict[str, Any] = {}
        self._span_ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()    # guards enable/reset/export only
        self._lifetime = 0               # events ever recorded (never reset)
        self._overwritten = 0            # events ever lost to ring
                                         #   wraparound (monotone, never
                                         #   reset — silent data loss must
                                         #   stay visible across resets)
        self._reset_state()

    def _reset_state(self) -> None:
        self._ring: list = [None] * self._capacity
        self._n = 0                      # ring write index since last reset
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._by_name: dict[str, int] = {}
        self._open: dict[int, dict] = {}
        self._t0 = time.perf_counter()

    # -- lifecycle -----------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self, capacity: int | None = None) -> None:
        with self._lock:
            if capacity is not None and int(capacity) != self._capacity:
                self._capacity = int(capacity)
                self._reset_state()
            self._enabled = True

    def disable(self) -> None:
        """Stop recording; already-recorded events stay exportable."""
        self._enabled = False

    def reset(self) -> None:
        """Drop recorded events/counters/gauges (the lifetime count and the
        registered providers survive, so lifetime deltas attribute
        events across resets)."""
        with self._lock:
            self._reset_state()

    # -- recording (no-op fast path: one branch when disabled) ---------------
    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _record(self, rec: dict) -> None:
        i = self._n
        self._n = i + 1
        self._lifetime += 1
        if i >= self._capacity:          # this write evicts the oldest event
            self._overwritten += 1
        self._ring[i % self._capacity] = rec
        name = rec["name"]
        self._by_name[name] = self._by_name.get(name, 0) + 1

    def _merge_tags(self, args: dict) -> dict:
        stack = getattr(self._local, "tags", None)
        if not stack:
            return args
        merged: dict = {}
        for t in stack:
            merged.update(t)
        merged.update(args)
        return merged

    def event(self, name: str, **args: Any) -> None:
        """Record one instant event (Chrome phase ``"i"``)."""
        if not self._enabled:
            return
        self._record({"name": name, "ph": "i", "ts": self._now_us(),
                      "tid": threading.get_ident(),
                      "args": self._merge_tags(args)})

    def counter(self, name: str, delta: float = 1) -> None:
        if not self._enabled:
            return
        self._counters[name] = self._counters.get(name, 0) + delta

    def gauge(self, name: str, value: float) -> None:
        if not self._enabled:
            return
        self._gauges[name] = value

    # -- spans ---------------------------------------------------------------
    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def begin(self, name: str, parent: int | None = None,
              **args: Any) -> int | None:
        """Open a span; returns its id (None when disabled — ``end(None)``
        is a no-op, so call sites need no second branch)."""
        if not self._enabled:
            return None
        sid = next(self._span_ids)
        if parent is None:
            stack = getattr(self._local, "stack", None)
            if stack:
                parent = stack[-1]
        a = self._merge_tags(args)
        a["span_id"] = sid
        if parent is not None:
            a["parent_id"] = parent
        self._open[sid] = {"name": name, "ph": "X", "ts": self._now_us(),
                           "dur": 0.0, "tid": threading.get_ident(),
                           "args": a}
        return sid

    def end(self, span_id: int | None, **extra: Any) -> None:
        """Close a span (recording it, with duration); merges ``extra`` into
        its args — values only known at completion (supersteps, cache
        hits) attach to the span that produced them."""
        if span_id is None:
            return
        rec = self._open.pop(span_id, None)
        if rec is None:
            return
        rec["dur"] = self._now_us() - rec["ts"]
        if extra:
            rec["args"].update(extra)
        self._record(rec)

    @contextlib.contextmanager
    def span(self, name: str, parent: int | None = None, **args: Any):
        """Context-managed span; nests via a per-thread stack (children
        opened inside default their parent to this span)."""
        if not self._enabled:
            yield None
            return
        sid = self.begin(name, parent=parent, **args)
        stack = self._stack()
        stack.append(sid)
        try:
            yield sid
        finally:
            stack.pop()
            self.end(sid)

    @contextlib.contextmanager
    def tags(self, **tags: Any):
        """Ambient tags: merged into every event/span recorded on this
        thread inside the block (explicit args win on key collision)."""
        if not self._enabled:
            yield
            return
        stack = getattr(self._local, "tags", None)
        if stack is None:
            stack = self._local.tags = []
        stack.append(tags)
        try:
            yield
        finally:
            stack.pop()

    # -- introspection -------------------------------------------------------
    def events(self) -> list[dict]:
        """Recorded events, oldest first (ring contents since last reset)."""
        n, cap = self._n, self._capacity
        if n <= cap:
            return [e for e in self._ring[:n] if e is not None]
        head = n % cap
        return [e for e in self._ring[head:] + self._ring[:head]
                if e is not None]

    def stats(self) -> dict:
        return {"enabled": self._enabled, "capacity": self._capacity,
                "recorded": self._lifetime,
                "since_reset": self._n,
                "dropped": max(0, self._n - self._capacity),
                "overwritten": self._overwritten,
                "open_spans": len(self._open)}

    def gauges(self) -> dict[str, float]:
        """Latest gauge values (a copy) — the monitor's watchers read these
        without paying ``snapshot()``'s provider calls."""
        return dict(self._gauges)

    def counters(self) -> dict[str, float]:
        """Current counter values (a copy)."""
        return dict(self._counters)

    # -- providers + snapshot ------------------------------------------------
    def register_provider(self, name: str, fn: Callable[[], dict]
                          ) -> Callable[[], None]:
        """Attach a stats source to ``snapshot()``; returns an unregister
        callable.  Bound methods are stored as weakrefs so a dead owner
        (an un-closed GraphServer) silently drops out."""
        if hasattr(fn, "__self__"):
            self._providers[name] = weakref.WeakMethod(fn)
        else:
            self._providers[name] = fn

        def unregister() -> None:
            self._providers.pop(name, None)
        return unregister

    def snapshot(self) -> dict:
        """One structured record of everything the recorder knows: ring
        stats, counters, gauges (latest partition-health values from the
        stream), per-name event counts, and every registered provider's
        live stats — the full cache hierarchy in one call."""
        out = dict(self.stats())
        out["counters"] = dict(self._counters)
        out["gauges"] = dict(self._gauges)
        out["events_by_name"] = dict(self._by_name)
        for name in list(self._providers):
            fn = self._providers[name]
            if isinstance(fn, weakref.WeakMethod):
                live = fn()
                if live is None:                 # owner collected: prune
                    self._providers.pop(name, None)
                    continue
                fn = live
            # one broken provider must not abort the whole snapshot — it
            # is exactly the degraded state a postmortem snapshot is FOR
            try:
                out[name] = fn()
            except Exception as e:               # noqa: BLE001
                out[name] = {"error": f"{type(e).__name__}: {e}"}
        return out


_RECORDER = Recorder()


def get() -> Recorder:
    """The process-global recorder every subsystem records into."""
    return _RECORDER

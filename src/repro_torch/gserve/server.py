"""GraphServer — micro-batched multi-tenant serving over the engine (PyTorch).

The counterpart of ``repro.gserve.server`` over the port's engine: the
same micro-batches, cache probes, admission and results, dispatched
through ``Engine.dispatch_batched`` (lanes on the kernels' feature axis)
and ``Engine.dispatch`` with the engine's own ``use_kernels``, so on the
card no request falls back to the plain versions. Two parts of the
reference wait for their modules: ``from_session`` (streaming) and
``ledger=`` (the cost model); both raise ``NotImplementedError``.

The server pulls five pieces together:

  * the engine's ``ProgramRegistry``: every servable program declared its
    schema once, and the server *derives* dispatch from the entry — the
    batch-axis name/dtype, the superstep-count parameter, derived
    per-snapshot resources (e.g. PageRank's degree vector), cacheability.
    No program is named anywhere in this package; registering a new
    program makes it servable with zero edits here;
  * a ``MicroBatcher`` (scheduler.py) that coalesces compatible requests
    from many tenants into fixed-shape micro-batches (pad-to-bucket), with
    per-tenant pending counts feeding fair-share admission and a
    timer-based flush bounding tail latency at low offered load;
  * the partitioned engine's dispatch: ``drain()`` is software pipelined —
    micro-batch i+1 is formed and dispatched before batch i's
    ``PendingResult`` is collected (the port's superstep loop reads the
    device once a sweep, so little overlaps);
  * an epoch-keyed ``ResultCache`` (cache.py) keyed by graph content
    fingerprint — tenants share answers, and every plan swap drops stale
    entries.  Alongside it, a *warm-start store* keeps the last computed
    result per query key together with the fingerprint it was computed at:
    when the graph has only gained edges since (insert-only lineage,
    tracked via the session's ``last_change``), a new dispatch of the same
    query warm-starts from the old result through the program's
    ``warm_init`` hook — repairing e.g. SSSP distances in one or two
    supersteps instead of recomputing from scratch;
  * a *double-buffered plan swap*: the server holds one immutable
    ``_PlanBuffer`` (engine + graph snapshot + fingerprint + version).  A
    streaming session (the reference's ``repro.stream``, not ported yet)
    calls the epoch-change hook ``_on_plan_change``; on each event the
    server builds a fresh buffer and atomically swaps the front pointer.  In-flight micro-batches captured the OLD buffer at dispatch
    time and keep draining against it (plans are immutable — there is no
    torn/half-patched state to observe); batches formed after the
    swap see the new one.  Every result is stamped with the buffer it was
    served from, so callers can check consistency against that exact
    snapshot.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time

import numpy as np
import torch

from .. import obs as _obs
from ..core.graph import Graph
from ..engine.errors import ChannelError
from ..engine.registry import ProgramEntry
from ..engine.runtime import Engine, PendingResult
from .cache import ResultCache
from .metrics import ServeMetrics
from .request import AdmissionError, QueryRequest, QueryResult
from .scheduler import (DEFAULT_BUCKETS, MicroBatch, MicroBatcher,
                        bucket_for, pad_params)

_BATCH_DTYPES = {int: torch.int32, float: torch.float32}
#: What the port has not ported yet (ROADMAP.md, queue 1).
_NO_STREAMING = ("GraphServer.from_session needs the streaming session, "
                 "which the port does not have yet (ROADMAP.md, queue 1: "
                 "Streaming)")
_NO_LEDGER = ("GraphServer ledger= needs the cost ledger and its cost "
              "model, which the port does not have yet (ROADMAP.md, "
              "queue 1: Observability)")
_SERVER_IDS = itertools.count()   # obs provider names: serve0, serve1, ...


def _host(a) -> np.ndarray:
    """A result tensor (or number) as a host array."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


def _frozen(a: np.ndarray) -> np.ndarray:
    """Mark an array read-only. Served values and cache entries are shared
    across tenants (and with the cache itself); a tenant mutating its
    result must fail loudly, not corrupt everyone else's answers."""
    a.flags.writeable = False
    return a


@dataclasses.dataclass(frozen=True)
class _PlanBuffer:
    """One immutable serving snapshot: everything a micro-batch needs."""
    engine: Engine
    graph: Graph
    epoch: int
    version: int

    def fingerprint(self) -> str:
        """Content hash of the snapshot — the result-cache key. Lazy and
        memoized: a stream update with no query in between never pays the
        O(E log E) hash; a queried buffer hashes exactly once."""
        cached = self.__dict__.get("_fingerprint")
        if cached is None:
            cached = self.graph.fingerprint()
            object.__setattr__(self, "_fingerprint", cached)
        return cached

    def resource(self, name: str, fn) -> object:
        """Memoized registry-declared resources (e.g. pagerank's degree
        vector), derived from the graph snapshot on first use and shared
        by every micro-batch served from this buffer."""
        cache = self.__dict__.get("_resources")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_resources", cache)
        if name not in cache:
            cache[name] = fn(self.graph)
        return cache[name]


@dataclasses.dataclass
class _InFlight:
    """A dispatched micro-batch awaiting completion."""
    batch: MicroBatch
    buffer: _PlanBuffer
    pending: PendingResult | None     # None: fully served from cache
    lane_of: dict[int, int]           # request id -> dispatched lane
    cached: dict[int, np.ndarray]     # request id -> cache-served value
    n_lanes: int                      # deduped uncached lanes dispatched
    bucket: int                       # padded dispatch shape (0: no dispatch)
    t_dispatch: float                 # perf_counter at dispatch
    warm_lanes: frozenset = frozenset()
                                      # dispatched lane indices that warm-
                                      #   started from a prior epoch's
                                      #   result (others ran cold +inf rows)
    error: str | None = None          # dispatch-time failure for the whole
                                      #   batch (channel plane invalidated
                                      #   by a swap): requests get error
                                      #   results, the drain loop lives on
    span: int | None = None           # open obs "serve.batch" span id —
                                      #   execute/materialize spans attach
                                      #   to it explicitly (the pipelined
                                      #   drain interleaves batches, so
                                      #   stack nesting cannot carry it)


class GraphServer:
    """Accepts typed query requests from many logical tenants and serves
    them in micro-batches over a (possibly live/streaming) partition plan.

    Construct over a static ``Engine`` + ``Graph``::

        server = GraphServer(engine=eng, graph=g)

    A plan change reaches the server through ``_on_plan_change``, the
    epoch-change hook a streaming session calls (``from_session`` waits
    for the port's streaming module).

    ``max_wait_s`` (optional) arms the timer-based flush: ``drain()`` then
    lets partial buckets wait up to the deadline for more requests to
    coalesce before dispatching.  ``warm_entries=0`` disables warm-started
    repair dispatch.

    ``monitor`` (optional, a ``repro.obs.Monitor``) receives every
    completion (tenant, program, end-to-end latency) and every admission
    rejection (``ok=False``), and is rate-limitedly evaluated after each
    completed batch — SLO burn-rate alerts fire as ``obs.alert`` events
    without a separate polling thread.  The feed is guarded by the
    recorder's ``enabled`` flag (the observability master switch), so a
    disabled recorder keeps the serving hot path monitor-free.

    ``ledger`` must be ``None``: the cost ledger is not ported yet.
    """

    def __init__(self, engine: Engine, graph: Graph, *,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 max_pending: int = 1024, cache_entries: int = 512,
                 max_wait_s: float | None = None,
                 warm_entries: int = 256, monitor=None, ledger=None,
                 epoch: int = 0, version: int = 0):
        self.buckets = tuple(buckets)
        self.max_pending = int(max_pending)
        self.max_wait_s = max_wait_s
        self.monitor = monitor
        self.metrics = ServeMetrics()
        self.cache = ResultCache(cache_entries)
        self._batcher = MicroBatcher(self.buckets)
        self._lock = threading.RLock()
        self._t_submit: dict[int, float] = {}
        # bounded: callers that keep ids around collect via result(); old
        # completed entries age out instead of leaking on long-lived servers
        self._results: "collections.OrderedDict[int, QueryResult]" = \
            collections.OrderedDict()
        self._results_max = max(4 * self.max_pending, 4096)
        # warm-start store: cache_key -> (fingerprint, value). Entries
        # outlive plan swaps (that is their point); validity is decided at
        # dispatch time against _warm_ok, the set of fingerprints connected
        # to the front buffer by insert-only content changes.
        self._warm_max = int(warm_entries)
        self._warm: "collections.OrderedDict[tuple, tuple[str, np.ndarray]]"\
            = collections.OrderedDict()
        self._warm_ok: set[str] = set()
        self._cache_dirty = False
        # the engine keeps its use_kernels (where the reference forces its
        # XLA path): on the card every micro-batch runs the kernels
        self._front = _PlanBuffer(engine, graph, int(epoch), int(version))
        self.set_ledger(ledger)
        # obs: one snapshot shows the whole hierarchy — this server's
        # metrics (result cache included) join the plan-cache and
        # kernel-launch providers; stats is held by weakref, so an
        # un-closed server that gets collected drops out instead of leaking
        self._obs_unregister = _obs.get().register_provider(
            f"serve{next(_SERVER_IDS)}", self.stats)

    @classmethod
    def from_session(cls, session, **kwargs) -> "GraphServer":
        """Bind to a streaming session (the reference's
        ``repro.stream.StreamSession``): not ported yet."""
        raise NotImplementedError(_NO_STREAMING)

    def close(self) -> None:
        self._obs_unregister()

    # -- cost accounting ------------------------------------------------------
    def set_ledger(self, ledger) -> None:
        """Wire a cost ledger: only ``None`` (no ledger) is supported until
        the cost ledger is ported."""
        if ledger is not None:
            raise NotImplementedError(_NO_LEDGER)
        self.ledger = None

    # -- plan double-buffering ----------------------------------------------
    def _on_plan_change(self, session, event: str) -> None:
        """Epoch-change hook: build the new buffer and swap the front
        pointer. In-flight batches hold the previous buffer object and
        finish against it. The result cache is marked dirty rather than
        purged here — invalidation needs the new content fingerprint, and
        hashing the edge set on the stream's update hot path would tax
        updates that no query ever observes; the purge runs on the next
        cache access instead (stale entries are unreachable in between:
        every probe is keyed by the captured buffer's fingerprint).

        Warm-start lineage: an insert-only (or content-neutral) change
        keeps previous results valid as relaxation upper bounds, so the
        outgoing buffer's fingerprint joins ``_warm_ok``; any deletion
        breaks the chain and clears the warm store wholesale."""
        buf = _PlanBuffer(session.engine, session.graph(),
                          int(session.epoch), int(session.version))
        delta = getattr(session, "last_change", {}).get("content_delta",
                                                        "mixed")
        with self._lock:
            old = self._front
            self._front = buf
            self._cache_dirty = True
            if delta in ("none", "insert_only"):
                # only a *queried* buffer memoized its fingerprint; an
                # unqueried one has no warm entries keyed to it either
                old_fp = old.__dict__.get("_fingerprint")
                if old_fp is not None:
                    # prune lineage for fingerprints no warm entry holds
                    # any more (LRU-evicted): bounds _warm_ok at
                    # warm_entries + 1 on append-only streams
                    live = {fp for fp, _ in self._warm.values()}
                    self._warm_ok &= live
                    self._warm_ok.add(old_fp)
            else:
                self._warm_ok.clear()
                self._warm.clear()
            self.metrics.record_swap()
        _obs.get().event("serve.plan_swap", version=buf.version,
                         epoch=buf.epoch, content_delta=delta)

    def _maybe_invalidate_cache(self) -> None:
        """Deferred swap cleanup; call with the lock held, before any cache
        probe or fill."""
        if self._cache_dirty:
            self.cache.invalidate_except(self._front.fingerprint())
            self._cache_dirty = False

    @property
    def front(self) -> _PlanBuffer:
        with self._lock:
            return self._front

    # -- request intake ------------------------------------------------------
    def submit(self, req: QueryRequest) -> int:
        """Enqueue one request; returns its id.

        Admission control sheds load at the door rather than queue without
        bound, with a per-tenant fair share: a tenant may hold at most
        ``max_pending // active_tenants`` pending requests (active = has
        pending requests, counting the submitter).  A tenant with nothing
        pending is always allowed its first request even when the queue is
        globally full — so one tenant saturating the queue can never lock
        a quiet tenant out entirely.  The exemption is itself bounded:
        total pending never exceeds ``2 * max_pending``, so a flood of
        fresh tenant ids cannot defeat load shedding.

        Every admission decision is recorded as a ``serve.admission`` span
        tagged with the tenant and request — the root of the request's
        span tree, and the audit trail for fair-share rejections."""
        rec = _obs.get()
        sid = rec.begin("serve.admission", request=req.id,
                        tenant=req.tenant, program=req.kind) \
            if rec.enabled else None
        try:
            rid = self._submit(req)
        except AdmissionError as e:
            rec.end(sid, admitted=False, reason=str(e))
            if self.monitor is not None and rec.enabled:
                # a shed request is an availability failure for its tenant
                self.monitor.observe(req.tenant, req.kind, 0.0, ok=False)
                self.monitor.maybe_evaluate()
            raise
        rec.end(sid, admitted=True)
        return rid

    def _submit(self, req: QueryRequest) -> int:
        if req.entry.channel_params:
            # fail malformed property planes at the door (typed ChannelError
            # naming the expected shape) instead of inside a later drain —
            # shape checks only, the layout itself happens per batch
            req.entry.validate_channels(req.params, self.front.engine.plan)
        with self._lock:
            n_active = len(self._batcher.active_tenants() | {req.tenant})
            share = max(1, self.max_pending // n_active)
            mine = self._batcher.tenant_pending(req.tenant)
            total = len(self._batcher)
            if mine >= share:
                self.metrics.record_rejection(fair_share=n_active > 1)
                raise AdmissionError(
                    f"tenant {req.tenant!r} holds {mine} pending requests "
                    f">= its fair share ({share}; {self.max_pending} max "
                    f"pending / {n_active} active tenants)")
            if total >= self.max_pending and mine > 0:
                self.metrics.record_rejection()
                raise AdmissionError(
                    f"pending queue full ({self.max_pending})")
            if total >= 2 * self.max_pending:
                # hard wall: even the first-request exemption sheds load
                # once fresh-tenant overshoot doubles the queue
                self.metrics.record_rejection()
                raise AdmissionError(
                    f"pending queue at hard limit ({2 * self.max_pending})")
            self._t_submit[req.id] = time.perf_counter()
            self._batcher.add(req)
            return req.id

    def pending(self) -> int:
        with self._lock:
            return len(self._batcher)

    # -- micro-batch execution ----------------------------------------------
    @staticmethod
    def _warm_key(entry: ProgramEntry, key: tuple) -> tuple:
        """Warm-store key: the query key prefixed with the program's
        ``StateSpec`` identity, so a re-registered program with a different
        per-vertex rank can never warm-start from stale planes of the old
        shape (the runtime would reject them with ``WarmStateError``, but
        keying them apart means they simply miss instead of erroring)."""
        return (entry.state.key(),) + tuple(key)

    def _warm_block(self, entry: ProgramEntry, params0: dict,
                    padded_params: tuple, buffer: _PlanBuffer
                    ) -> tuple[np.ndarray | None, frozenset]:
        """([bucket, *state.shape(V)] warm-start block or None, warm lane
        indices) for a batchable dispatch.

        Lane i warm-starts from the stored result for the same query key
        when that result's snapshot is an insert-only ancestor of the
        buffer being dispatched against; lanes without one get cold rows
        from the program's ``StateSpec`` ("no prior information" — the
        warm_init contract cold-starts them) and are NOT in the returned
        index set. Call with the lock held."""
        if entry.program.warm_init is None or self._warm_max <= 0 \
                or not self._warm:
            return None, frozenset()
        fp_front = buffer.fingerprint()
        rows: list[np.ndarray | None] = []
        warm_lanes = set()
        for li, p in enumerate(padded_params):
            got = self._warm.get(
                self._warm_key(entry, entry.lane_cache_key(params0, p)))
            if got is not None and (got[0] in self._warm_ok
                                    or got[0] == fp_front):
                rows.append(got[1])
                warm_lanes.add(li)
            else:
                rows.append(None)
        if not warm_lanes:
            return None, frozenset()
        cold = entry.state.cold(buffer.graph.n_vertices)
        return (np.stack([r if r is not None else cold for r in rows]),
                frozenset(warm_lanes))

    def _store_warm(self, entry: ProgramEntry, key: tuple, fp: str,
                    value: np.ndarray) -> None:
        """Remember the latest computed result per query key (lock held)."""
        if entry.program.warm_init is None or self._warm_max <= 0:
            return
        wkey = self._warm_key(entry, key)
        self._warm[wkey] = (fp, value)
        self._warm.move_to_end(wkey)
        while len(self._warm) > self._warm_max:
            self._warm.popitem(last=False)

    def _dispatch_batch(self, batch: MicroBatch,
                        buffer: _PlanBuffer) -> _InFlight:
        """Hand one micro-batch to the engine without syncing — entirely
        derived from the program's registry entry (batch axis, superstep
        cap, snapshot resources): no program is named here. Cache lookups
        happen at *serve* time, against the captured buffer's
        fingerprint — a request submitted before a plan swap but batched
        after it is answered (and labelled) with the post-swap snapshot."""
        req0 = batch.requests[0]
        entry = req0.entry
        params0 = req0.params
        eng = buffer.engine
        rec = _obs.get()
        # per-tenant span tags: the batch span names every rider, so a
        # trace answers "whose requests shared this dispatch" directly
        bsid = rec.begin(
            "serve.batch", program=req0.kind,
            n_requests=len(batch.requests),
            requests=[r.id for r in batch.requests],
            tenants=sorted({r.tenant for r in batch.requests}),
            version=buffer.version, epoch=buffer.epoch) \
            if rec.enabled else None
        steps = entry.supersteps_of(params0)
        kw = {name: buffer.resource(name, fn) for name, fn in entry.resources}
        kw.update(entry.ctx_args(params0))
        # property channels: the registry lays the request's content-hashed
        # planes out against the captured buffer's plan (their digests are
        # already part of this batch's batch/cache keys — nothing here
        # depends on which channels, if any, the program declares). A plane
        # validated at submit can be invalidated by a plan swap landing
        # before the batch was popped (hwm grown past it / e_pad changed):
        # that fails THIS batch with per-request error results instead of
        # throwing away the drain pipeline and wedging waiting submitters.
        try:
            kw.update(entry.channel_args(params0, eng.plan))
        except ChannelError as e:
            return _InFlight(batch, buffer, None, {}, {}, 0, 0,
                             time.perf_counter(), error=str(e), span=bsid)
        cached: dict[int, np.ndarray] = {}
        lane_of: dict[int, int] = {}
        pending = None
        n_lanes = 0
        bucket = 0
        warm_lanes: frozenset = frozenset()

        if batch.params is not None:            # batchable program
            # per-lane cache probe, then dispatch only the uncached lanes
            lane_val: dict[int, np.ndarray] = {}
            uncached: list[int] = []
            warm_state = None
            with self._lock:
                self._maybe_invalidate_cache()
                for li, p in enumerate(batch.params):
                    hit = self.cache.get(buffer.fingerprint(),
                                         entry.lane_cache_key(params0, p))
                    if hit is not None:
                        lane_val[li] = hit
                    else:
                        uncached.append(li)
                if uncached:
                    n_lanes = len(uncached)
                    bucket = bucket_for(n_lanes, self.buckets)
                    params = pad_params(tuple(batch.params[li]
                                              for li in uncached), bucket)
                    warm_state, warm_lanes = self._warm_block(
                        entry, params0, params, buffer)
            for r, li in zip(batch.requests, batch.lane):
                if li in lane_val:
                    cached[r.id] = lane_val[li]
                else:
                    lane_of[r.id] = uncached.index(li)
            if uncached:
                # pad duplicates beyond the real lanes don't serve anyone
                warm_lanes = frozenset(li for li in warm_lanes
                                       if li < n_lanes)
                bp = entry.batch_param
                bkw = {bp.name: torch.tensor(params,
                                             dtype=_BATCH_DTYPES[bp.dtype],
                                             device=eng.plan.device)}
                dsid = rec.begin("serve.dispatch", parent=bsid,
                                 bucket=bucket, lanes=n_lanes,
                                 warm_lanes=len(warm_lanes)) \
                    if rec.enabled else None
                pending = eng.dispatch_batched(
                    entry.program, bkw,
                    max_supersteps=steps, warm_state=warm_state, **kw)
                rec.end(dsid)
        else:                                   # one shared run
            key = req0.cache_key()
            with self._lock:
                self._maybe_invalidate_cache()
                hit = self.cache.get(buffer.fingerprint(), key)
            if hit is not None:
                for r in batch.requests:
                    cached[r.id] = hit
            else:
                n_lanes = bucket = 1
                dsid = rec.begin("serve.dispatch", parent=bsid, bucket=1,
                                 lanes=1) if rec.enabled else None
                pending = eng.dispatch(entry.program, max_supersteps=steps,
                                       **kw)
                rec.end(dsid)
        if pending is not None:
            self.metrics.record_batch(len(batch.requests) - len(cached),
                                      n_lanes, bucket, len(warm_lanes))
        return _InFlight(batch, buffer, pending, lane_of, cached,
                         n_lanes, bucket, time.perf_counter(), warm_lanes,
                         span=bsid)

    def _complete(self, fl: _InFlight) -> list[QueryResult]:
        """Sync one in-flight batch and materialise per-request results."""
        values: dict[int, np.ndarray] = dict(fl.cached)
        supersteps: dict[int, int] = {}
        entry = fl.batch.requests[0].entry
        rec = _obs.get()
        msid = None
        if fl.pending is not None:
            esid = rec.begin("serve.execute", parent=fl.span,
                             bucket=fl.bucket, lanes=fl.n_lanes) \
                if rec.enabled else None
            # execute time = device sync + host materialisation of the
            # state block (device_time_s)
            t_exec = time.perf_counter()
            res = fl.pending.result()
            state = _host(res.state)
            ss = _host(res.supersteps).reshape(-1)
            self.metrics.record_execute(time.perf_counter() - t_exec)
            rec.end(esid, supersteps=int(ss.max()) if len(ss) else 0)
            msid = rec.begin("serve.materialize", parent=fl.span,
                             n_requests=len(fl.batch.requests)) \
                if rec.enabled else None
            if fl.batch.params is not None:
                # fan dispatched lanes back out + fill the cache; copy each
                # lane so neither results nor cache entries pin the whole
                # [bucket, V] batch array through a numpy view
                lane_arr = {dl: _frozen(state[dl].copy())
                            for dl in set(fl.lane_of.values())}
                for rid, dl in fl.lane_of.items():
                    values[rid] = lane_arr[dl]
                    supersteps[rid] = int(ss[min(dl, len(ss) - 1)])
                with self._lock:
                    # the warm store keeps every computed result (validity
                    # is re-derived at use time from its fingerprint), but
                    # only fill the result cache if no swap landed
                    # mid-flight: a put keyed by a dead fingerprint would
                    # re-insert a stale entry the deferred invalidation
                    # already (or will never) see
                    fp = fl.buffer.fingerprint()
                    fresh = (not self._cache_dirty
                             and fp == self._front.fingerprint())
                    for rid, dl in fl.lane_of.items():
                        req = next(r for r in fl.batch.requests
                                   if r.id == rid)
                        self._store_warm(entry, req.cache_key(), fp,
                                         lane_arr[dl])
                        if fresh and entry.cacheable:
                            self.cache.put(fp, req.cache_key(),
                                           lane_arr[dl])
            else:
                state = _frozen(state)
                for r in fl.batch.requests:
                    values[r.id] = state
                    supersteps[r.id] = int(ss.max())
                if entry.cacheable:
                    with self._lock:
                        if (not self._cache_dirty
                                and fl.buffer.fingerprint()
                                == self._front.fingerprint()):
                            self.cache.put(fl.buffer.fingerprint(),
                                           fl.batch.requests[0].cache_key(),
                                           state)
        now = time.perf_counter()
        out = []
        with self._lock:
            for r in fl.batch.requests:
                t0 = self._t_submit.pop(r.id, now)
                qr = QueryResult(
                    request=r, value=values.get(r.id),
                    version=fl.buffer.version, epoch=fl.buffer.epoch,
                    fingerprint=fl.buffer.fingerprint(),
                    supersteps=supersteps.get(r.id, 0),
                    from_cache=r.id in fl.cached,
                    batch_size=len(fl.batch.requests), bucket=fl.bucket,
                    latency_s=now - t0,
                    warm_start=fl.lane_of.get(r.id, -1) in fl.warm_lanes,
                    error=fl.error)
                self._results[r.id] = qr
                self.metrics.record_result(qr.latency_s, qr.from_cache)
                out.append(qr)
            while len(self._results) > self._results_max:
                self._results.popitem(last=False)
        rec.end(msid)
        rec.end(fl.span, n_cached=len(fl.cached),
                failed=fl.error is not None)
        if self.monitor is not None and rec.enabled:
            # outside the lock: observe() only touches monitor-owned rings
            for qr in out:
                self.monitor.observe(qr.request.tenant, qr.request.kind,
                                     qr.latency_s, ok=qr.error is None)
            self.monitor.maybe_evaluate()
        return out

    def pump(self) -> list[QueryResult]:
        """Serve exactly one micro-batch (or nothing if the queue is empty)."""
        with self._lock:
            batch = self._batcher.next_batch()
            buffer = self._front
        if batch is None:
            return []
        return self._complete(self._dispatch_batch(batch, buffer))

    def drain(self, max_wait_s: float | None = None) -> list[QueryResult]:
        """Serve until the queue is empty, software-pipelined: the next
        micro-batch is formed and dispatched while the previous one's
        device computation settles.

        With ``max_wait_s`` (argument, or the server-level default) the
        scheduler defers partial buckets: a batchable queue that cannot
        fill the largest bucket waits — for concurrent submitters to top
        it up — until its oldest request hits the deadline, then flushes
        partial.  That bounds p99 at low offered load instead of wedging
        behind an unfillable bucket."""
        if max_wait_s is None:
            max_wait_s = self.max_wait_s
        done: list[QueryResult] = []
        inflight: _InFlight | None = None
        while True:
            now = time.perf_counter()
            with self._lock:
                batch = self._batcher.next_batch(now=now,
                                                 max_wait_s=max_wait_s)
                buffer = self._front
                waited = self._batcher.oldest_wait(now)
            nxt = (self._dispatch_batch(batch, buffer)
                   if batch is not None else None)
            if inflight is not None:
                done.extend(self._complete(inflight))
            inflight = nxt
            if inflight is None:
                if waited is None:      # queue truly empty
                    return done
                # queued work exists but is deferred to fill its bucket:
                # sleep toward the flush deadline, then re-check
                time.sleep(max(min(max_wait_s - waited, 1e-3), 1e-4))

    def serve(self, requests: list[QueryRequest]) -> list[QueryResult]:
        """Convenience: submit a burst and drain it; results in input order."""
        ids = [self.submit(r) for r in requests]
        self.drain()
        # a concurrent drainer may have coalesced some of our requests into
        # its own still-in-flight micro-batch: its queue pop beat ours, so
        # wait for those results to materialise rather than KeyError
        while any(i not in self._results for i in ids):
            self.drain()
            time.sleep(1e-3)
        return [self._results[i] for i in ids]

    def result(self, request_id: int) -> QueryResult | None:
        return self._results.get(request_id)

    def stats(self) -> dict:
        return self.metrics.snapshot(self.cache.stats())

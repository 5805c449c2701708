"""Micro-batch scheduler: coalesce compatible requests into fixed shapes.

A copy of ``repro.gserve.scheduler`` (stdlib only), so the port forms the
same micro-batches as the reference.

Why fixed shapes: the batcher *pads to a bucket*: a batch of S batchable
requests is padded up to the smallest configured bucket >= S (repeating
the last parameter — the duplicate lanes compute a result that is simply
dropped), so the engine only ever sees a few lane counts.  The reference
pads so that every micro-batch hits a warm jit cache; the port's kernels
take any lane count, and a few fixed shapes let the allocator reuse its
blocks from batch to batch.

Coalescing rules (request.batch_key — derived from the program registry):

  * programs with a batchable parameter (SSSP, weighted SSSP, BFS, ...) —
    up to ``max(buckets)`` requests per dispatch, duplicate parameters
    deduped into one lane and fanned back out;
  * programs without one (WCC, PageRank-with-same-iters) — ANY number of
    concurrent requests collapse into ONE engine run shared by every
    requesting tenant.

Queues are FIFO per batch key and keys are drained in arrival order of
their oldest request, so no tenant's query class can starve another's.
When a usage ledger is wired (the reference's; not ported yet), draining
becomes cost-weighted
(``cost_of``): keys whose head tenant has burned the smallest recent
device-time share flush first, so cheap tenants are not stuck behind a
heavy tenant's backlog.

Timer-based flush: ``next_batch(max_wait_s=...)`` *defers* a batchable key
that cannot yet fill the largest bucket — until its oldest request has
waited ``max_wait_s``, at which point the partial bucket dispatches
anyway.  That bounds p99 latency at low offered load while still giving
bursts time to coalesce (``GraphServer.drain`` drives the ticks).

The batcher also tracks per-tenant pending counts — the server's
fair-share admission control reads them at the door.
"""
from __future__ import annotations

import collections
import dataclasses
import time

from .request import QueryRequest

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32)


def bucket_for(n: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket >= n (buckets sorted ascending)."""
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


def pad_params(params: tuple, bucket: int) -> tuple:
    """THE padding rule: fill the bucket by repeating the last parameter
    (duplicate lanes compute a dropped result). Single-sourced here — the
    server re-pads after cache filtering with the same rule."""
    return tuple(params) + (params[-1],) * (bucket - len(params))


@dataclasses.dataclass(frozen=True)
class MicroBatch:
    """One schedulable unit: requests answerable by a single dispatch."""
    key: tuple                        # shared batch_key
    requests: tuple[QueryRequest, ...]
    params: tuple | None              # deduped batched-parameter values
    lane: tuple[int, ...] | None      # per-request index into params
    bucket: int                       # padded dispatch shape (>= len(params))

    @property
    def padded_params(self) -> tuple | None:
        if self.params is None:
            return None
        return pad_params(self.params, self.bucket)


class MicroBatcher:
    """FIFO micro-batch former over per-batch-key queues."""

    def __init__(self, buckets: tuple[int, ...] = DEFAULT_BUCKETS):
        assert buckets == tuple(sorted(buckets)) and len(buckets) >= 1
        self.buckets = tuple(int(b) for b in buckets)
        # each queue holds (request, arrival_time) pairs; arrival times are
        # time.perf_counter() (monotonic — NTP steps must not fake waits),
        # and every ``now`` passed into next_batch/oldest_wait must come
        # from the same clock
        self._queues: "collections.OrderedDict[tuple, collections.deque]" = \
            collections.OrderedDict()
        self._arrival = 0
        self._order: dict[tuple, int] = {}   # key -> oldest arrival seq
        self._tenant = collections.Counter()  # tenant -> pending requests
        # cost-weighted flush ordering: when the server wires a usage
        # ledger, cost_of maps tenant -> recent device-time share and keys
        # drain cheapest-head-tenant first (FIFO breaks the tie), so a
        # tenant monopolizing the device queues behind everyone it starved
        self.cost_of: "collections.abc.Callable[[str], float] | None" = None

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    # -- fair-share accounting (read by GraphServer.submit) ------------------
    def tenant_pending(self, tenant: str) -> int:
        return self._tenant.get(tenant, 0)

    def active_tenants(self) -> set[str]:
        return {t for t, n in self._tenant.items() if n > 0}

    def add(self, req: QueryRequest) -> None:
        key = req.batch_key()
        q = self._queues.get(key)
        if q is None:
            q = self._queues[key] = collections.deque()
        if not q:
            self._order[key] = self._arrival
        q.append((req, time.perf_counter()))
        self._tenant[req.tenant] += 1
        self._arrival += 1

    def _live_keys(self) -> list[tuple]:
        """Keys with queued requests: oldest head first, or — with a
        ledger-backed ``cost_of`` wired — cheapest head tenant first
        (arrival order inside one tenant's cost tier)."""
        live = [(seq, key) for key, seq in self._order.items()
                if self._queues.get(key)]
        if self.cost_of is None:
            return [key for _, key in sorted(live)]
        ranked = sorted((self.cost_of(self._queues[key][0][0].tenant),
                         seq, key) for seq, key in live)
        return [key for _, _, key in ranked]

    def next_batch(self, now: float | None = None,
                   max_wait_s: float | None = None) -> MicroBatch | None:
        """Form one micro-batch from the first *ready* queue in arrival
        order of queue heads.

        Without a timer every non-empty queue is ready (greedy draining,
        the default).  With ``max_wait_s`` set, a batchable queue that
        cannot fill the largest bucket is deferred until its head request
        has waited the deadline out — the timer-based flush that bounds
        tail latency at low offered load.  Non-batchable queues dispatch
        immediately (all queued requests share one run regardless).
        """
        for key in self._live_keys():
            q = self._queues[key]
            head, t_head = q[0]
            if (max_wait_s is not None and head.entry.batchable
                    and len(q) < self.buckets[-1]
                    and (now if now is not None else time.perf_counter()) - t_head
                    < max_wait_s):
                continue                     # let the bucket fill
            return self._form(key)
        return None

    def oldest_wait(self, now: float | None = None) -> float | None:
        """Age of the oldest pending request (None when empty) — lets the
        drain loop sleep until the next deadline instead of busy-polling."""
        heads = [self._queues[k][0][1] for k in self._live_keys()]
        if not heads:
            return None
        return (now if now is not None else time.perf_counter()) - min(heads)

    def _form(self, key: tuple) -> MicroBatch:
        q = self._queues[key]
        head, _ = q[0]
        if head.entry.batchable:
            take = min(len(q), self.buckets[-1])
            reqs = tuple(q.popleft()[0] for _ in range(take))
            # dedupe identical parameters into one lane
            params: list = []
            lane: list[int] = []
            seen: dict = {}
            pname = head.entry.batch_param.name
            for r in reqs:
                p = r.params[pname]
                if p not in seen:
                    seen[p] = len(params)
                    params.append(p)
                lane.append(seen[p])
            bucket = bucket_for(len(params), self.buckets)
            batch = MicroBatch(key, reqs, tuple(params), tuple(lane), bucket)
        else:
            # parameterless: every queued request shares one run
            reqs = tuple(q.popleft()[0] for _ in range(len(q)))
            batch = MicroBatch(key, reqs, None, None, 1)
        for r in reqs:
            self._tenant[r.tenant] -= 1
            if self._tenant[r.tenant] <= 0:
                del self._tenant[r.tenant]
        if not q:
            self._order.pop(key, None)
        return batch

"""Typed query requests and results for the serving subsystem.

A copy of ``repro.gserve.request`` over the port's program registry.

A request names a *program* (any entry in the engine's ``ProgramRegistry``)
plus its per-query ``params`` and the logical tenant that issued it::

    QueryRequest("sssp", tenant="alice", params={"source": 7})
    QueryRequest("pagerank", params={"iters": 20})
    QueryRequest("wcc")

Validation, dtype coercion and default-filling all happen at construction,
against the program's declarative ``ParamSpec`` schema — this module knows
no program by name.  Normalisation makes query identity canonical: two
spellings of the same logical query (e.g. pagerank with ``iters`` omitted
vs passed as its default) share one ``batch_key()``/``cache_key()``, so
they coalesce into one dispatch and share one cache entry.

Two requests are *batchable* together when they share a ``batch_key()``:
same program, same value for every non-batchable parameter — the scheduler
then answers them with one engine dispatch (the batchable parameter, e.g.
the SSSP source, carries the micro-batch's lane axis; parameterless
programs like WCC collapse to a single run fanned out to every requester).

Results carry full provenance: the plan-buffer version and compaction epoch
they were served against, the graph fingerprint of that snapshot, whether
they came from the epoch-keyed result cache, and whether the dispatch was
warm-started from a previous epoch's result.  The consistency contract
(tests/test_torch_gserve.py) is that ``value`` is bit-identical to the
whole-graph oracle evaluated on the snapshot named by ``fingerprint``
(within the entry's ``oracle_atol`` for add programs).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Mapping

import numpy as np

from ..engine.registry import DEFAULT_REGISTRY, ProgramEntry


class AdmissionError(RuntimeError):
    """Raised by ``GraphServer.submit`` when the pending queue is full or
    the tenant exceeded its fair share of it."""


_REQUEST_IDS = itertools.count()


@dataclasses.dataclass(frozen=True)
class QueryRequest:
    kind: str                         # a registered program name
    tenant: str = "default"
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    id: int = dataclasses.field(default_factory=lambda: next(_REQUEST_IDS))

    def __post_init__(self):
        # resolve + normalize against the registry schema NOW: every
        # constructed request is valid, canonical, and cheap to key
        entry = DEFAULT_REGISTRY.get(self.kind)
        object.__setattr__(self, "params", entry.normalize(self.params))

    @property
    def entry(self) -> ProgramEntry:
        return DEFAULT_REGISTRY.get(self.kind)

    def batch_key(self) -> tuple:
        """Requests sharing a batch key may be answered by one dispatch."""
        return self.entry.batch_key_of(self.params)

    def cache_key(self) -> tuple:
        """Identity of the *answer* (within one graph snapshot): tenant is
        deliberately excluded — tenants share cached results, that is the
        multi-tenant amortisation the layout exists for."""
        return self.entry.cache_key_of(self.params)


@dataclasses.dataclass(frozen=True)
class QueryResult:
    request: QueryRequest
    value: np.ndarray | None          # [V] final vertex state (None iff
                                      #   ``error`` is set)
    version: int                      # plan-buffer version served against
    epoch: int                        # plan compaction epoch of that buffer
    fingerprint: str                  # Graph.fingerprint() of the snapshot
    supersteps: int
    from_cache: bool
    batch_size: int                   # real requests in the micro-batch
    bucket: int                       # padded batch shape dispatched
    latency_s: float                  # submit -> result materialised
    warm_start: bool = False          # dispatched warm from a prior epoch
    error: str | None = None          # per-request failure (e.g. a channel
                                      #   plane invalidated by a plan swap
                                      #   between submit and dispatch) —
                                      #   the batch fails, the server keeps
                                      #   serving

    def row(self) -> dict[str, Any]:
        return {"id": self.request.id, "kind": self.request.kind,
                "tenant": self.request.tenant, "version": self.version,
                "epoch": self.epoch, "from_cache": self.from_cache,
                "batch_size": self.batch_size, "bucket": self.bucket,
                "latency_s": self.latency_s, "warm_start": self.warm_start,
                "error": self.error}

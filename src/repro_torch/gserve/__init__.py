"""repro_torch.gserve — graph query serving (PyTorch port).

The counterpart of ``repro.gserve``: micro-batched multi-tenant serving
over the port's partitioned engine. Typed query requests name any program
registered in the engine's ``ProgramRegistry``
(``QueryRequest(kind, params={...})``); validation, batching, caching and
dispatch are all derived from the registry entry. Requests are coalesced
into padded micro-batches (a timer-based flush bounds tail latency at low
load), admitted under per-tenant fair shares, and answered through
``Engine.dispatch_batched`` (the lanes ride the kernels' feature axis)
with an epoch-keyed result cache. ``GraphServer.from_session`` binds a
server to a streaming session (``repro_torch.stream``); ``ledger=`` (a
``repro_torch.obs.CostLedger``) prices every batch and makes admission
and flush order cost-weighted.

    from repro_torch import engine as E, gserve as G
    plan = E.compile_plan_cached(g, owner, 16)
    srv = G.GraphServer(E.Engine(plan), g)
    out = srv.serve([G.QueryRequest("sssp", params={"source": 0})])
"""
from .cache import ResultCache
from .metrics import ServeMetrics, percentile
from .request import AdmissionError, QueryRequest, QueryResult
from .scheduler import DEFAULT_BUCKETS, MicroBatch, MicroBatcher, bucket_for
from .server import GraphServer

__all__ = [
    "AdmissionError", "DEFAULT_BUCKETS", "GraphServer", "MicroBatch",
    "MicroBatcher", "QueryRequest", "QueryResult", "ResultCache",
    "ServeMetrics", "bucket_for", "percentile",
]

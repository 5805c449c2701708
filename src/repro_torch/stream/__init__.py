"""repro_torch.stream — streaming graph subsystem: incremental DFEP
maintenance and engine plan patching for a live (mutating) edge set.

Counterpart of ``repro.stream``. Pipeline: StreamingGraph chunked ingest →
online HDRF assignment seeded from DFEP owner state → PartitionPlan
patching (a new plan at the same shapes, its kernel layouts built on the
card before it is installed) → drift-triggered bounded local re-auction
(DFEP steps 1–2 on the h-hop region, on the device).
"""
from .assign import hdrf_assign, seed_state
from .ingest import ApplyResult, StreamingGraph, iter_chunks
from .patch import EdgeChange, SlackExhausted, patch_plan
from .policy import (AdaptiveCompactionPolicy, CompactionPolicy,
                     ReactiveCompactionPolicy)
from .reauction import h_hop_vertices, local_reauction
from .session import StreamConfig, StreamSession

__all__ = [
    "AdaptiveCompactionPolicy", "ApplyResult", "CompactionPolicy",
    "EdgeChange", "ReactiveCompactionPolicy", "SlackExhausted",
    "StreamConfig", "StreamSession", "StreamingGraph", "h_hop_vertices",
    "hdrf_assign", "iter_chunks", "local_reauction", "patch_plan",
    "seed_state",
]

"""repro_torch.engine — edge-centric partitioned execution engine (PyTorch).

Pipeline: partition (``core/dfep.py``) → :func:`compile_plan` (or the
content-addressed :func:`compile_plan_cached`) → ``Engine.run(program)``,
or ``Engine.run_batched`` for a micro-batch of queries, with the sweeps
(``segment_reduce``, or ``gspmm`` for the GNN programs) and the replica
exchange going through the Hopper kernels of ``engine/kernels.py``.
``Engine(plan, group=...)`` shards the partitions over the ranks of a
``torch.distributed`` process group (``shard_plan``,
``exchange_sharded``).
Programs declare themselves once in the ``ProgramRegistry``
(``engine/registry.py``) and the serving stack (``repro_torch.gserve``)
derives everything downstream from the entry.
"""
from .errors import (BatchAxisError, ChannelError, DuplicateProgramError,
                     ParamTypeError, RegistryError, StateError,
                     UnknownParamError, UnknownProgramError, WarmStateError)
from .kernels import (LAUNCHES, exchange_sharded, gather_edge_channel,
                      gather_vertex_channel, gspmm, gspmm_ref, masked_update,
                      masked_update_ref, reset_launches, segment_reduce,
                      segment_reduce_ref)
from .plan import (PartitionPlan, compile_plan, compile_plan_cached,
                   plan_cache_clear, plan_cache_stats, plan_from_numpy,
                   shard_plan)
from .registry import (DEFAULT_REGISTRY, ChannelValue, ParamSpec,
                       ProgramEntry, ProgramRegistry, bind_channel,
                       get_program, program_names, register, resident_stats,
                       unbind_channel, unregister)
from .programs import (BFS, GCN_F_IN, GCN_F_OUT, GCN_LAYER, KGE_F,
                       KGE_SCORE, LABELPROP, PAGERANK, PPR, SSSP, WCC,
                       WEIGHTED_SSSP, engine_bfs, engine_gcn_layer,
                       engine_kge_score, engine_label_propagation,
                       engine_pagerank, engine_personalized_pagerank,
                       engine_sssp, engine_wcc, engine_weighted_sssp,
                       multi_source_sssp)
from .runtime import EdgeProgram, Engine, EngineResult, PendingResult
from .state import SCALAR, StateSpec

__all__ = [
    "BFS", "BatchAxisError", "ChannelError", "ChannelValue",
    "DEFAULT_REGISTRY", "DuplicateProgramError", "EdgeProgram", "Engine",
    "EngineResult", "GCN_F_IN", "GCN_F_OUT", "GCN_LAYER", "KGE_F",
    "KGE_SCORE", "LABELPROP", "LAUNCHES", "PAGERANK", "PPR", "ParamSpec",
    "ParamTypeError", "PartitionPlan", "PendingResult", "ProgramEntry",
    "ProgramRegistry", "RegistryError", "SCALAR", "SSSP", "StateError",
    "StateSpec", "UnknownParamError", "UnknownProgramError", "WCC",
    "WEIGHTED_SSSP", "WarmStateError", "bind_channel", "compile_plan",
    "compile_plan_cached", "engine_bfs", "engine_gcn_layer",
    "engine_kge_score", "engine_label_propagation", "engine_pagerank",
    "engine_personalized_pagerank", "engine_sssp", "engine_wcc",
    "engine_weighted_sssp", "exchange_sharded", "gather_edge_channel", "gather_vertex_channel",
    "get_program", "gspmm", "gspmm_ref", "masked_update",
    "masked_update_ref", "multi_source_sssp", "plan_cache_clear",
    "plan_cache_stats", "plan_from_numpy", "program_names", "register",
    "reset_launches", "resident_stats", "segment_reduce",
    "segment_reduce_ref", "shard_plan", "unbind_channel", "unregister",
]

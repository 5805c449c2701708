"""repro_torch.engine — edge-centric partitioned execution engine (PyTorch).

Pipeline: partition (``core/dfep.py``) → :func:`compile_plan` →
``Engine.run(program)``, with the sweeps (``segment_reduce``, or ``gspmm``
for the GNN programs) and the replica exchange going through the Hopper
kernels of ``engine/kernels.py``.
"""
from .errors import (BatchAxisError, ChannelError, DuplicateProgramError,
                     ParamTypeError, RegistryError, StateError,
                     UnknownParamError, UnknownProgramError, WarmStateError)
from .kernels import (LAUNCHES, gather_edge_channel, gather_vertex_channel,
                      gspmm, gspmm_ref, masked_update, masked_update_ref,
                      reset_launches, segment_reduce, segment_reduce_ref)
from .plan import PartitionPlan, compile_plan, plan_from_numpy
from .programs import (BFS, GCN_F_IN, GCN_F_OUT, GCN_LAYER, KGE_F,
                       KGE_SCORE, LABELPROP, PAGERANK, PPR, SSSP, WCC,
                       WEIGHTED_SSSP, engine_bfs, engine_gcn_layer,
                       engine_kge_score, engine_label_propagation,
                       engine_pagerank, engine_personalized_pagerank,
                       engine_sssp, engine_wcc, engine_weighted_sssp)
from .runtime import EdgeProgram, Engine, EngineResult, PendingResult
from .state import SCALAR, StateSpec

__all__ = [
    "BFS", "BatchAxisError", "ChannelError", "DuplicateProgramError",
    "EdgeProgram", "Engine", "EngineResult", "GCN_F_IN", "GCN_F_OUT",
    "GCN_LAYER", "KGE_F", "KGE_SCORE", "LABELPROP", "LAUNCHES", "PAGERANK",
    "PPR", "ParamTypeError", "PartitionPlan", "PendingResult",
    "RegistryError", "SCALAR", "SSSP", "StateError", "StateSpec",
    "UnknownParamError", "UnknownProgramError", "WCC", "WEIGHTED_SSSP",
    "WarmStateError", "compile_plan", "engine_bfs", "engine_gcn_layer",
    "engine_kge_score", "engine_label_propagation", "engine_pagerank",
    "engine_personalized_pagerank", "engine_sssp", "engine_wcc",
    "engine_weighted_sssp", "gather_edge_channel", "gather_vertex_channel",
    "gspmm", "gspmm_ref", "masked_update", "masked_update_ref",
    "plan_from_numpy", "reset_launches", "segment_reduce",
    "segment_reduce_ref",
]

"""repro_torch.engine — edge-centric partitioned execution engine (PyTorch).

Pipeline: partition (``core/dfep.py``) → :func:`compile_plan` →
``Engine.run(program)``, with the sweeps and the replica exchange going
through the Hopper kernels of ``engine/kernels.py``.
"""
from .errors import (BatchAxisError, ChannelError, DuplicateProgramError,
                     ParamTypeError, RegistryError, StateError,
                     UnknownParamError, UnknownProgramError, WarmStateError)
from .kernels import (LAUNCHES, masked_update, masked_update_ref,
                      reset_launches, segment_reduce, segment_reduce_ref)
from .plan import PartitionPlan, compile_plan, plan_from_numpy
from .programs import (PAGERANK, SSSP, WCC, engine_pagerank, engine_sssp,
                       engine_wcc)
from .runtime import EdgeProgram, Engine, EngineResult, PendingResult
from .state import SCALAR, StateSpec

__all__ = [
    "BatchAxisError", "ChannelError", "DuplicateProgramError", "EdgeProgram",
    "Engine", "EngineResult", "LAUNCHES", "PAGERANK", "ParamTypeError",
    "PartitionPlan", "PendingResult", "RegistryError", "SCALAR", "SSSP",
    "StateError", "StateSpec", "UnknownParamError", "UnknownProgramError",
    "WCC", "WarmStateError", "compile_plan", "engine_pagerank",
    "engine_sssp", "engine_wcc", "masked_update", "masked_update_ref",
    "plan_from_numpy", "reset_launches", "segment_reduce",
    "segment_reduce_ref",
]

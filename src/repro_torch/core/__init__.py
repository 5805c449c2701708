"""Core of the paper in PyTorch: the graph container, DFEP edge
partitioning, the ETSCH framework with its problems, the partition metrics
and the baseline partitioners; the multi-device DFEP and ETSCH over a
``torch.distributed`` process group (``collectives``,
``dfep_distributed``, ``etsch_distributed``); and DFEP-balanced MoE
expert placement (``moe_dfep``)."""
from . import (algorithms, baselines, collectives, dfep,  # noqa: F401
               dfep_distributed, etsch, etsch_distributed, graph, metrics,
               moe_dfep)
from .dfep import DfepConfig, partition, run_dfep  # noqa: F401
from .etsch import Partitioning, compile_partitioning, run_etsch  # noqa: F401
from .graph import (Graph, from_edge_array, graph_from_numpy,  # noqa: F401
                    load_dataset)

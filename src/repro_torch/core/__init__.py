"""Core of the paper in PyTorch: the graph container and DFEP edge
partitioning."""
from . import dfep, graph  # noqa: F401
from .dfep import DfepConfig, partition, run_dfep  # noqa: F401
from .graph import (Graph, from_edge_array, graph_from_numpy,  # noqa: F401
                    load_dataset)

"""The edge-weight rule of the graph's weighted queries, frozen.

A copy of ``src/repro_torch/core/graph.py::edge_weights``: a content hash of
the undirected endpoint pair, mapped to float32 in [1, 2). The reference
works the weights out from the edge list itself.
"""
from __future__ import annotations

import numpy as np

_MOD = 1_000_003


def edge_weights(u, v) -> np.ndarray:
    """Per-edge float32 weights in [1, 2) of the undirected pairs (u, v)."""
    a = np.minimum(u, v).astype(np.int64)
    b = np.maximum(u, v).astype(np.int64)
    h = (a * 2654435761 + b * 97_571 + 12_345) % _MOD
    return (1.0 + h / _MOD).astype(np.float32)

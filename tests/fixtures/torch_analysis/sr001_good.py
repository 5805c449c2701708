# analysis-virtual-path: gserve/warm.py
"""Good twin of incident_scalar_state.py: the cold rows come from the
program entry's declared ``StateSpec``, so scalar and vector-state
programs share one allocation path — and explicit rank-2 shapes (a
deliberate ``(V, F)`` tuple) are not the analyzer's business."""
import numpy as np
import torch


def warm_block(entry, rows, buffer):
    cold = torch.from_numpy(entry.state.cold(buffer.graph.n_vertices))
    return torch.stack([r if r is not None else cold for r in rows])


def scratch_plane(buffer, features):
    # explicit rank choice: fine
    return (torch.zeros((buffer.graph.n_vertices, features)),
            np.zeros((buffer.graph.n_vertices, features), np.float32))

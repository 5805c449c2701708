# analysis-virtual-path: gserve/warm.py
"""Incident fixture — the implicit scalar-state-rank hazard.

Before the ``StateSpec`` API, the reference's serving warm store filled
missing warm-start lanes with ``np.full(buffer.graph.n_vertices, np.inf)``
— one float per vertex, hard-coded.  The first vector-state program
(``gcn_layer``, ``[V, F]`` per-vertex planes) would have warm-started from
a rank-1 block and crashed in a reshape deep inside the engine, lanes
already batched, long after admission.  In the port that row is one
``torch.full`` away; the fix allocates through the program entry's
declared spec (``entry.state.cold(V)``); SR001 must flag it forever."""
import torch


def warm_block(entry, rows, buffer):
    cold = torch.full((buffer.graph.n_vertices,), torch.inf)  # FLAG: SR001
    return torch.stack([r if r is not None else cold for r in rows])

# analysis-virtual-path: gserve/lanes.py
"""SR001 bad: per-vertex state allocated rank-1 by torch and numpy,
aliased imports and the ``size=`` keyword included."""
import numpy
import torch as T
from torch import empty


def lanes(buffer, graph):
    a = T.zeros(graph.n_vertices)  # FLAG: SR001
    b = empty(size=(buffer.graph.n_vertices,))  # FLAG: SR001
    c = T.ones([graph.n_vertices], dtype=T.int32)  # FLAG: SR001
    d = numpy.empty(shape=graph.n_vertices)  # FLAG: SR001
    return a, b, c, d

"""State-shape rules: per-vertex state rank is declared, never assumed.

The port of ``repro.analysis.stateshape``, over numpy's allocators and
torch's.

Incident record (the reason this family exists): before the ``StateSpec``
API, the reference's serving warm store manufactured cold warm-start rows
with ``np.full(buffer.graph.n_vertices, np.inf, np.float32)`` —
hard-coding the assumption that every program keeps exactly one float
per vertex.  The first vector-state program (``gcn_layer``, ``[V, F]``
planes) would have warm-started from a rank-1 block and died in a reshape
deep inside the engine, lanes already batched, long after the request was
admitted.  Every cold/warm allocation goes through ``entry.state.cold(V)``
/ ``StateSpec.shape(V)`` so the program's declared rank is the only rank
decision point.  The port holds state in torch tensors as well as numpy
arrays, so the rule watches ``torch.full(...)`` beside ``np.full(...)``:

SR001  in gserve, no raw numpy or torch allocation (``full``/``zeros``/
       ``ones``/``empty``) shaped directly by ``<...>.n_vertices`` — that
       bakes an implicit scalar-per-vertex rank into the serving tier;
       derive the shape from the program entry's ``StateSpec`` instead.
"""
from __future__ import annotations

import ast
from typing import Iterator

from .base import (Finding, ImportMap, ModuleInfo, Rule, dotted,
                   qualname_at, register_rule)

_ALLOCATORS = {f"{lib}.{fn}" for lib in ("numpy", "torch")
               for fn in ("full", "zeros", "ones", "empty")}


def _shape_is_n_vertices(node: ast.AST) -> bool:
    """True when a shape argument is ``<...>.n_vertices`` itself or a
    1-tuple/1-list wrapping it — both pin the per-vertex rank to scalar.
    ``(g.n_vertices, F)`` is an explicit rank-2 choice and is left alone."""
    if isinstance(node, (ast.Tuple, ast.List)):
        if len(node.elts) != 1:
            return False
        node = node.elts[0]
    return isinstance(node, ast.Attribute) and node.attr == "n_vertices"


class ImplicitScalarStateRank(Rule):
    id = "SR001"
    family = "state-shape"
    name = "implicit-scalar-state-rank"
    summary = ("gserve must not allocate per-vertex state with np./torch."
               "full/zeros/ones/empty shaped by .n_vertices — that "
               "hard-codes scalar rank; use the program entry's "
               "StateSpec (entry.state.cold / .shape) instead")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if mod.subsystem != "gserve":
            return
        imports = ImportMap(mod)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            if not d or imports.resolve(d) not in _ALLOCATORS:
                continue
            shape = node.args[0] if node.args else None
            for kw in node.keywords:
                if kw.arg in ("shape", "size"):
                    shape = kw.value
            if shape is None or not _shape_is_n_vertices(shape):
                continue
            yield self.finding(
                mod, node, qualname_at(mod.tree, node),
                f"{d}(... n_vertices ...) hard-codes one scalar per vertex "
                "in the serving tier; vector-state programs declare their "
                "rank in StateSpec — allocate via entry.state.cold(V) / "
                "entry.state.shape(V)")


register_rule(ImplicitScalarStateRank())

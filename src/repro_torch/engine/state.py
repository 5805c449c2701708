"""Declarative per-vertex state shape for superstep programs.

A copy of ``repro.engine.state`` (stdlib + numpy only), kept in the port
so that ``repro_torch`` imports nothing of the JAX package.

A program's state need not be a scalar ``[V]`` float32 plane.
``StateSpec`` makes the rank declarative — a program states how many
features each vertex carries and what a "cold" (no prior information) row
looks like, and every layer derives its shapes from that one declaration:

* ``runtime.Engine`` validates ``warm_state`` against ``spec.shape(V)``
  (or ``spec.batch_shape(S, V)`` for batched dispatch) and raises a
  typed :class:`~repro_torch.engine.errors.WarmStateError` instead of
  letting a rank mismatch surface as a shape error deep in a superstep;
* the gserve warm store keys its blocks by ``spec.key()`` and builds
  cold rows with ``spec.cold(V)``, so a program re-registered with a
  different state rank can never replay an old-rank block;
* scalar programs are simply the default ``StateSpec()`` — the F=1
  special case of the one code path, not a separate branch.

The module imports only stdlib + numpy so both ``registry`` and
``runtime`` can depend on it without cycles.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["SCALAR", "StateSpec"]


@dataclasses.dataclass(frozen=True)
class StateSpec:
    """Shape/dtype/init contract for one program's per-vertex state.

    ``features == 1`` means scalar state served as a rank-1 ``[V]``
    plane (the legacy shape, bit-identical to the pre-StateSpec path);
    ``features > 1`` means a ``[V, F]`` feature plane.  ``fill`` is the
    cold-row value warm blocks use for vertices with no prior epoch —
    ``inf`` for min-combine distances, typically ``0`` for feature
    planes.
    """

    features: int = 1
    dtype: str = "float32"
    fill: float = math.inf

    def __post_init__(self) -> None:
        if not isinstance(self.features, int) or self.features < 1:
            raise ValueError(
                f"StateSpec.features must be a positive int, "
                f"got {self.features!r}")
        np.dtype(self.dtype)  # raises TypeError on gibberish

    def shape(self, n_vertices: int) -> tuple[int, ...]:
        """Finalized result shape for ``n_vertices`` vertices.

        The single place the scalar-vs-vector rank decision lives:
        ``(V,)`` for scalar programs, ``(V, F)`` for feature planes.
        """
        if self.features == 1:
            return (n_vertices,)
        return (n_vertices, self.features)

    def batch_shape(self, batch: int, n_vertices: int) -> tuple[int, ...]:
        """Shape of a batched (leading lane axis) result block."""
        return (batch,) + self.shape(n_vertices)

    def cold(self, n_vertices: int) -> np.ndarray:
        """A fresh "no prior information" row block (warm-store filler)."""
        return np.full(self.shape(n_vertices), self.fill,
                       np.dtype(self.dtype))

    def key(self) -> tuple:
        """Hashable identity for warm-store keying: two programs whose
        state blocks are interchangeable share a key, nothing else does."""
        return (self.features, self.dtype, self.fill)

    def describe(self) -> str:
        """Human-readable shape tag for error messages."""
        if self.features == 1:
            return f"scalar [V] {self.dtype}"
        return f"[V, {self.features}] {self.dtype}"


#: The legacy implicit contract, now spelled out: scalar float32, cold=inf.
SCALAR = StateSpec()

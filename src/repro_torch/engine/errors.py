"""Typed errors for the program registry and warm-started dispatch.

A copy of ``repro.engine.errors`` (stdlib only), kept in the port so that
``repro_torch`` imports nothing of the JAX package.

Every registry misuse raises a distinct subclass of ``RegistryError`` with
an actionable message (what was wrong, what the caller should pass
instead).  ``RegistryError`` subclasses ``ValueError`` so pre-registry
callers that caught ``ValueError`` on bad requests keep working.

Kept in their own module so both ``engine.registry`` (validation) and
``engine.runtime`` (warm-state shape checks at dispatch) can raise them
without importing each other.
"""
from __future__ import annotations


class RegistryError(ValueError):
    """Base class for program-registry misuse."""


class DuplicateProgramError(RegistryError):
    """A program name was registered twice."""


class UnknownProgramError(RegistryError):
    """A query named a program that was never registered."""


class UnknownParamError(RegistryError):
    """A query passed a parameter the program's ParamSpec does not declare."""


class ParamTypeError(RegistryError):
    """A parameter value has the wrong dtype, or a required one is missing."""


class BatchAxisError(RegistryError):
    """A scalar parameter was passed a sequence/array (a batch axis).

    The micro-batch axis is formed by the scheduler coalescing *requests*;
    a single request always carries scalar parameter values.
    """


class StateError(RegistryError):
    """Base class for state-plane shape violations at the server door.

    A program's per-vertex state rank is declared by its ``StateSpec``;
    every array whose shape must agree with that declaration —
    warm-start blocks, bound channel planes — raises a ``StateError``
    subclass when it does not, instead of a shape error deep in a
    superstep.
    """


class WarmStateError(StateError):
    """``warm_state`` was passed to a program without a ``warm_init`` hook,
    or its shape does not match the plan's vertex space under the
    program's ``StateSpec`` (wrong vertex count *or* wrong feature rank)."""


class ChannelError(StateError):
    """A property-channel value is malformed: wrong rank/feature width at
    construction, or — at dispatch — a plane whose leading length does not
    match the plan it is being served against (e.g. a ``[V, F]`` vertex
    plane passed where an edge-slot plane was declared, or vice versa)."""

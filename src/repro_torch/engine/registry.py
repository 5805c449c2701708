"""Declarative program registry — one source of truth from ``EdgeProgram``
to ``GraphServer`` (PyTorch).

The counterpart of ``repro.engine.registry``, with the same schema, the
same derived keys and the same typed errors and messages. The one change
is residency: channel planes are uploaded as torch tensors onto the plan's
device, keyed by (digest, rows, device).

The paper's framework claim is that an edge-partitioned runtime is
"flexible enough to be applied to several different graph problems"
(§III).  Before this module the serving stack hardwired exactly three:
the query layer duplicated the program list, carried per-kind request
fields and branched on kind strings in its scheduler and server.  Now a
program registers **once** with a declarative ``ParamSpec`` schema and
everything downstream is *derived*:

  * ``gserve.QueryRequest(kind, params={...})`` — validation, dtype
    coercion and default normalisation (so e.g. ``iters=None`` and the
    default 30 are the *same* query identity);
  * scheduler ``batch_key`` — which requests may share one engine
    dispatch (the single ``batchable`` param carries the micro-batch
    axis; all other params must agree);
  * epoch-cache ``cache_key`` — the identity of an answer within one
    graph snapshot;
  * server dispatch — batch-axis name/dtype, the superstep-count param
    (``role="supersteps"``), and derived per-snapshot ``resources``
    (e.g. PageRank's degree vector) all come from the entry;
  * tests and benchmarks — ``oracle`` names the whole-graph reference
    the program must reproduce (``oracle_atol`` its tolerance).

Registering a new program therefore makes it servable end-to-end with
zero serving-layer edits — see "Registering your own program" in
the reference's src/repro/engine/README.md, with weighted SSSP as the
worked example. All misuse raises the typed errors in ``engine.errors``.

**Property channels** (``role="channel"``): a program may declare named
external feature planes — per-vertex ``[V, F]`` or per-edge ``[E_pad, F]``
in graph edge-slot order — supplied at query time as arrays (or bound once
per epoch via ``bind_channel``).  Values are wrapped in content-addressed
``ChannelValue``s whose sha256 digest folds into the derived batch/cache
keys, so feature-dependent results never alias across tenants; at dispatch
``ProgramEntry.channel_args`` validates each plane against the concrete
plan and the program's ``prepare`` gathers it to partition-local padded
buffers (``engine.kernels.gather_vertex_channel`` /
``gather_edge_channel``).  Label propagation over external labels and
personalized PageRank register this way (engine/programs.py).
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import numbers
import threading
from typing import Any, Callable, Mapping

import numpy as np
import torch

from .. import obs as _obs
from .errors import (BatchAxisError, ChannelError, DuplicateProgramError,
                     ParamTypeError, RegistryError, UnknownParamError,
                     UnknownProgramError)
from .state import SCALAR, StateSpec

_REQUIRED = object()        # sentinel: ParamSpec without a default
_DTYPES = (int, float)
_ROLES = ("ctx", "supersteps", "channel")
_CHANNELS = ("vertex", "edge", "dense")
_CHANNEL_SHAPES = {"vertex": "[V, F]", "edge": "[E_pad, F]",
                   "dense": "[R, F]"}


class ChannelValue:
    """One immutable, content-addressed property plane.

    Wraps a frozen float32 array — ``[V, F]`` for vertex channels, or
    ``[E_pad, F]`` in *graph edge-slot order* for edge channels — together
    with a sha256 digest of its contents.  Equality and hashing go through
    the digest, so a ``ChannelValue`` drops straight into the registry's
    derived ``batch_key``/``cache_key`` tuples: two tenants submitting
    byte-identical feature planes coalesce and share cached results, two
    tenants with *different* features never do — without the serving layer
    knowing channels exist.

    Construct once and reuse across requests ("bound once per epoch"
    client-side): the digest is computed a single time here, never per
    request.  ``np.asarray(cv)`` recovers the plane (oracles use this).
    """

    __slots__ = ("values", "digest")

    def __init__(self, values):
        try:
            # np.array (not asarray): ALWAYS copy, so the frozen plane can
            # never alias the caller's array — a caller mutating its own
            # buffer after construction must not change content the digest
            # already hashed, and freezing must not poison the caller
            v = np.array(values, np.float32)
        except (TypeError, ValueError) as e:
            raise ParamTypeError(
                f"channel values must be numeric arrays coercible to "
                f"float32, got {type(values).__name__}: {e}") from e
        if v.ndim == 1:
            v = v[:, None]
        if v.ndim != 2 or v.shape[0] == 0:
            raise ChannelError(
                f"a channel plane is a non-empty [N] or [N, F] array, got "
                f"shape {tuple(v.shape)}")
        v = np.ascontiguousarray(v)
        v.flags.writeable = False
        self.values = v
        h = hashlib.sha256()
        h.update(np.int64(v.shape[0]).tobytes())
        h.update(np.int64(v.shape[1]).tobytes())
        h.update(v.tobytes())
        self.digest = h.hexdigest()

    @property
    def shape(self) -> tuple:
        return tuple(self.values.shape)

    def __array__(self, dtype=None):
        return self.values if dtype is None else self.values.astype(dtype)

    def __eq__(self, other):
        return isinstance(other, ChannelValue) and self.digest == other.digest

    def __hash__(self):
        return hash(self.digest)

    def __repr__(self):
        return f"ChannelValue(shape={self.shape}, {self.digest[:12]}…)"


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative schema for one per-query parameter.

    dtype      — python scalar type (``int`` or ``float``); values are
                 coerced (numpy scalars accepted, bools rejected for int).
    default    — applied at request construction, so two spellings of the
                 same logical query share batch/cache identity; omit to
                 make the parameter required.
    batchable  — this parameter may carry the micro-batch axis: the
                 scheduler coalesces requests that differ only here into
                 one vmapped dispatch.  At most one per program.
    role       — "ctx": forwarded into the program's ``ctx`` via
                 engine kwargs; "supersteps": consumed host-side as the
                 superstep cap (``max_supersteps``); "channel": an external
                 property plane (see below).
    validate   — optional callback run on the coerced value; raise
                 ``ValueError`` to reject.
    channel    — for role="channel": "vertex" (a global ``[V, F]`` plane),
                 "edge" (an ``[E_pad, F]`` plane in graph edge-slot
                 order), or "dense" (a free-shape ``[R, F]`` operand tied
                 to no plan axis — e.g. a ``[F_in, F_out]`` GNN weight
                 matrix).  Values arrive as arrays (or pre-built
                 ``ChannelValue``); they are content-hashed into batch and
                 cache keys and laid out against the partition plan by
                 ``ProgramEntry.channel_args`` at dispatch (dense planes
                 pass through untouched).
    features   — declared feature width F of a channel plane (static, so
                 every query of the program has the same shapes).
    """
    name: str
    dtype: type = int
    default: Any = _REQUIRED
    batchable: bool = False
    role: str = "ctx"
    validate: Callable[[Any], None] | None = None
    channel: str | None = None
    features: int = 1

    @property
    def required(self) -> bool:
        return self.default is _REQUIRED

    def coerce(self, program: str, value: Any) -> Any:
        """Validate + coerce one value; raises the typed errors."""
        if self.role == "channel":
            return self._coerce_channel(program, value)
        if isinstance(value, (list, tuple, set)) \
                or getattr(value, "ndim", 0) > 0:
            if self.batchable:
                raise BatchAxisError(
                    f"{program}.{self.name} is batchable, but one request "
                    f"carries one scalar value (got {type(value).__name__}) "
                    "— submit one request per value; the scheduler forms "
                    "the batch axis by coalescing requests")
            raise BatchAxisError(
                f"{program}.{self.name} is not batchable and takes a "
                f"scalar {self.dtype.__name__} (got "
                f"{type(value).__name__}) — a batch axis may only ride on "
                "the program's batchable parameter")
        if self.dtype is int:
            if isinstance(value, bool) \
                    or not isinstance(value, numbers.Integral):
                raise ParamTypeError(
                    f"{program}.{self.name} expects int, got "
                    f"{type(value).__name__} ({value!r})")
            value = int(value)
        else:  # float: accept any real number
            if isinstance(value, bool) or not isinstance(value, numbers.Real):
                raise ParamTypeError(
                    f"{program}.{self.name} expects float, got "
                    f"{type(value).__name__} ({value!r})")
            value = float(value)
        if self.validate is not None:
            self.validate(value)
        return value

    def _coerce_channel(self, program: str, value: Any) -> "ChannelValue":
        if np.isscalar(value) or getattr(value, "ndim", None) == 0:
            raise ChannelError(
                f"{program}.{self.name} is a {self.channel} property "
                f"channel and takes an array plane "
                f"({_CHANNEL_SHAPES[self.channel]}"
                f" with F={self.features}), got a scalar "
                f"{type(value).__name__}")
        cv = value if isinstance(value, ChannelValue) else ChannelValue(value)
        if cv.values.shape[1] != self.features:
            raise ChannelError(
                f"{program}.{self.name} declares {self.features} "
                f"feature(s) per {self.channel}, got a plane of shape "
                f"{cv.shape} — reshape to [N, {self.features}]")
        if self.validate is not None:
            self.validate(cv)
        return cv


class _ResidentPlanes:
    """Device residency for channel planes, keyed by content digest.

    ``channel_args`` routes planes through this LRU: the first dispatch of
    a digest pays one upload to the plan's device and every later
    dispatch, including across plan swaps that leave the plane unchanged,
    reuses the resident tensor.  Keyed by (digest, padded rows, device):
    an edge plane's zero-padding to ``plan.e_slots`` is part of the
    uploaded bytes, and a plane on the card is never handed to a CPU plan
    (or the reverse).  Size and hit/miss counts surface as the
    ``channels.*`` obs gauge and provider.
    """

    def __init__(self, capacity: int = 64):
        self._lock = threading.Lock()
        self._planes: collections.OrderedDict = collections.OrderedDict()
        self._bytes = 0
        self._capacity = capacity
        self.hits = 0
        self.misses = 0

    def get(self, digest: str, vals: np.ndarray, device):
        key = (digest, vals.shape[0], str(device))
        with self._lock:
            arr = self._planes.get(key)
            if arr is not None:
                self._planes.move_to_end(key)
                self.hits += 1
                return arr
            self.misses += 1
            arr = torch.tensor(vals, device=device)     # a copy
            self._planes[key] = arr
            self._bytes += int(vals.nbytes)
            while len(self._planes) > self._capacity:
                _, old = self._planes.popitem(last=False)
                self._bytes -= old.numel() * old.element_size()
            total = self._bytes
        _obs.get().gauge("channels.resident_bytes", total)
        return arr

    def stats(self) -> dict:
        with self._lock:
            return {"resident_bytes": self._bytes,
                    "planes": len(self._planes),
                    "hits": self.hits, "misses": self.misses}


_RESIDENT = _ResidentPlanes()
_obs.get().register_provider("channels", _RESIDENT.stats)


def resident_stats() -> dict:
    """Snapshot of the device-resident channel-plane cache."""
    return _RESIDENT.stats()


@dataclasses.dataclass(frozen=True)
class ProgramEntry:
    """One registered program: the EdgeProgram plus everything the query
    layer derives (validation, batching, caching, dispatch, oracle)."""
    name: str
    program: Any                                # engine.runtime.EdgeProgram
    params: tuple[ParamSpec, ...]
    cacheable: bool = True                      # answers may enter the
                                                #   epoch-keyed result cache
    resources: tuple[tuple[str, Callable], ...] = ()
                                                # engine-kw -> fn(graph),
                                                #   derived per snapshot
    oracle: Callable | None = None              # oracle(graph, **params)
    oracle_atol: float = 0.0                    # 0.0 -> bit-identical
    # live channel bindings: param name -> ChannelValue, set through
    # bind_channel ("bound once per epoch") and consulted by normalize for
    # requests that omit the channel. Mutable contents on a frozen entry —
    # excluded from equality, never part of the schema.
    bindings: dict = dataclasses.field(default_factory=dict, compare=False,
                                       repr=False)

    # -- schema accessors ----------------------------------------------------
    @property
    def batch_param(self) -> ParamSpec | None:
        for p in self.params:
            if p.batchable:
                return p
        return None

    @property
    def batchable(self) -> bool:
        return self.batch_param is not None

    @property
    def channel_params(self) -> tuple[ParamSpec, ...]:
        return tuple(p for p in self.params if p.role == "channel")

    @property
    def state(self) -> StateSpec:
        """The program's declared per-vertex state shape.  Everything
        downstream (engine warm checks, gserve warm store and cold rows,
        result materialisation) derives shapes from this one property;
        programs predating the spec read as scalar."""
        return getattr(self.program, "state", SCALAR)

    def spec(self, name: str) -> ParamSpec:
        for p in self.params:
            if p.name == name:
                return p
        known = sorted(p.name for p in self.params) or ["<none>"]
        raise UnknownParamError(
            f"program {self.name!r} has no parameter {name!r}; "
            f"declared: {', '.join(known)}")

    # -- derivation ----------------------------------------------------------
    def normalize(self, params: Mapping[str, Any] | None) -> dict[str, Any]:
        """Coerce + default-fill a request's params. Normalisation at
        construction makes param identity canonical: omitted-with-default
        and explicitly-passed-default spell the SAME query (batch and
        cache keys are derived from the normalized dict)."""
        params = dict(params or {})
        out: dict[str, Any] = {}
        for spec in self.params:
            if spec.name in params:
                out[spec.name] = spec.coerce(self.name,
                                             params.pop(spec.name))
            elif spec.role == "channel" and spec.name in self.bindings:
                # a bound plane (bind_channel) stands in for the omitted
                # param — already coerced, digest already folded into keys
                out[spec.name] = self.bindings[spec.name]
            elif spec.required:
                raise ParamTypeError(
                    f"program {self.name!r} requires parameter "
                    f"{spec.name!r} ({spec.dtype.__name__}) and it has no "
                    "default — pass it in params={...}")
            else:
                # coerced so a numpy-scalar default lands canonical, same
                # as a caller-passed value (validated at registration too)
                out[spec.name] = spec.coerce(self.name, spec.default)
        if params:
            bad = sorted(params)
            known = sorted(p.name for p in self.params) or ["<none>"]
            raise UnknownParamError(
                f"program {self.name!r} has no parameter(s) "
                f"{', '.join(map(repr, bad))}; declared: {', '.join(known)}")
        return out

    def supersteps_of(self, params: Mapping[str, Any]) -> int | None:
        """The superstep cap for a dispatch (role="supersteps" param)."""
        for p in self.params:
            if p.role == "supersteps":
                return int(params[p.name])
        return None

    def ctx_args(self, params: Mapping[str, Any]) -> dict[str, Any]:
        """Non-batchable role="ctx" params, forwarded as engine kwargs."""
        return {p.name: params[p.name] for p in self.params
                if p.role == "ctx" and not p.batchable}

    # -- property channels ---------------------------------------------------
    def bind_channel(self, name: str, values) -> "ChannelValue":
        """Bind a plane once per epoch: requests that omit the channel
        param then resolve to this value at construction (and inherit its
        content digest in their batch/cache keys). Rebinding replaces the
        plane; a new digest is a new query identity, so results computed
        from the old plane are never served for the new one."""
        spec = self.spec(name)
        if spec.role != "channel":
            raise ChannelError(
                f"{self.name}.{name} has role={spec.role!r}, not 'channel' "
                "— only property channels can be bound")
        cv = spec.coerce(self.name, values)
        self.bindings[name] = cv
        return cv

    def unbind_channel(self, name: str) -> None:
        self.bindings.pop(name, None)

    def validate_channels(self, params: Mapping[str, Any], plan
                          ) -> dict[str, "ChannelValue"]:
        """Pure shape validation of the request's channel planes against a
        concrete plan — no layout work, cheap enough for the serving
        admission path.  A vertex plane must be ``[V, F]``; an edge plane
        ``[n, F]`` in graph edge-slot order with n covering every live
        slot and not exceeding the plan's static slot capacity.  Returns
        the coerced ``ChannelValue`` per param name."""
        out: dict[str, ChannelValue] = {}
        for spec in self.channel_params:
            cv = params[spec.name]
            if not isinstance(cv, ChannelValue):    # direct engine users
                cv = spec.coerce(self.name, cv)
            n = cv.values.shape[0]
            if spec.channel == "dense":
                # free-shape operand: no plan axis to agree with — rank and
                # feature width were already enforced at coercion
                out[spec.name] = cv
                continue
            if spec.channel == "vertex":
                if n != plan.n_vertices:
                    raise ChannelError(
                        f"{self.name}.{spec.name} is a VERTEX channel: "
                        f"expected [{plan.n_vertices}, {spec.features}] "
                        f"(one row per vertex), got {cv.shape} — an edge "
                        f"plane would be [{plan.e_slots}, {spec.features}] "
                        "in graph edge-slot order; did you mix them up?")
            else:
                need, cap = plan.edge_slot_hwm, plan.e_slots
                if n < need or n > cap:
                    raise ChannelError(
                        f"{self.name}.{spec.name} is an EDGE channel: "
                        f"expected [n, {spec.features}] rows in graph "
                        f"edge-slot order with {need} <= n <= {cap} (live "
                        f"slots .. padded capacity), got {cv.shape} — a "
                        f"vertex plane would be [{plan.n_vertices}, "
                        f"{spec.features}]; did you mix them up?")
            out[spec.name] = cv
        return out

    def channel_args(self, params: Mapping[str, Any], plan) -> dict[str, Any]:
        """Lay the request's channel planes out against ``plan`` and return
        them as engine kwargs (the program's ``prepare`` gathers them to
        partition-local ``[K, Vmax, F]`` / ``[K, Emax, F]`` buffers via
        ``kernels.gather_vertex_channel`` / ``gather_edge_channel``).

        Validates via ``validate_channels``; edge planes shorter than the
        plan's static slot capacity (e.g. exactly ``[E, F]`` on a freshly
        built graph) are zero-padded up to it, as the reference pads them.

        Returned planes are *device-resident* torch tensors on the plan's
        device: each (digest, rows, device) is uploaded once through the
        process-wide ``_ResidentPlanes`` LRU and reused across dispatches.
        """
        out: dict[str, Any] = {}
        for spec, cv in zip(self.channel_params,
                            self.validate_channels(params, plan).values()):
            vals = cv.values
            if spec.channel == "edge" and vals.shape[0] < plan.e_slots:
                pad = np.zeros((plan.e_slots - vals.shape[0],
                                vals.shape[1]), np.float32)
                vals = np.concatenate([vals, pad], axis=0)
            out[spec.name] = _RESIDENT.get(cv.digest, vals, plan.device)
        return out

    def batch_key_of(self, params: Mapping[str, Any]) -> tuple:
        """Requests sharing a batch key may be answered by one dispatch:
        same program, same value for every non-batchable parameter."""
        return (self.name,) + tuple(
            (p.name, params[p.name]) for p in self.params if not p.batchable)

    def cache_key_of(self, params: Mapping[str, Any]) -> tuple:
        """Identity of the *answer* within one graph snapshot: the program
        plus every normalized parameter (tenant deliberately excluded —
        result sharing across tenants is the point of the cache)."""
        return (self.name,) + tuple(
            (p.name, params[p.name]) for p in self.params)

    def lane_cache_key(self, params: Mapping[str, Any], value: Any) -> tuple:
        """Cache key of one lane of a micro-batch: the shared non-batch
        params with the batch param set to this lane's value."""
        bp = self.batch_param
        if bp is None:
            return self.cache_key_of(params)
        return self.cache_key_of({**params, bp.name: value})


class ProgramRegistry:
    """Name -> ProgramEntry map with validated registration."""

    def __init__(self):
        self._entries: dict[str, ProgramEntry] = {}

    def register(self, name: str, program, params=(), *,
                 cacheable: bool = True,
                 resources: Mapping[str, Callable] | None = None,
                 oracle: Callable | None = None,
                 oracle_atol: float = 0.0) -> ProgramEntry:
        """Register one EdgeProgram under ``name``. Everything the query
        layer needs is derived from this single call."""
        if name in self._entries:
            raise DuplicateProgramError(
                f"program {name!r} is already registered — unregister it "
                "first or register under a new name")
        params = tuple(params)
        seen: set[str] = set()
        batchable = []
        for p in params:
            if not isinstance(p, ParamSpec):
                raise RegistryError(
                    f"program {name!r}: params must be ParamSpec instances, "
                    f"got {type(p).__name__}")
            if p.name in seen:
                raise RegistryError(
                    f"program {name!r}: duplicate parameter {p.name!r}")
            seen.add(p.name)
            if p.dtype not in _DTYPES:
                raise RegistryError(
                    f"program {name!r}: parameter {p.name!r} dtype must be "
                    f"int or float, got {p.dtype!r}")
            if p.role not in _ROLES:
                raise RegistryError(
                    f"program {name!r}: parameter {p.name!r} role must be "
                    f"one of {_ROLES}, got {p.role!r}")
            if p.role == "channel":
                if p.channel not in _CHANNELS:
                    raise RegistryError(
                        f"program {name!r}: channel parameter {p.name!r} "
                        f"must set channel= to one of {_CHANNELS}, got "
                        f"{p.channel!r}")
                if p.dtype is not float:
                    raise RegistryError(
                        f"program {name!r}: channel parameter {p.name!r} "
                        "carries a float32 plane — declare dtype=float")
                if p.batchable:
                    raise RegistryError(
                        f"program {name!r}: channel parameter {p.name!r} "
                        "cannot be batchable — one plane is shared by the "
                        "whole micro-batch (its content hash is part of "
                        "the batch key)")
                if int(p.features) < 1:
                    raise RegistryError(
                        f"program {name!r}: channel parameter {p.name!r} "
                        f"needs features >= 1, got {p.features}")
            elif p.channel is not None:
                raise RegistryError(
                    f"program {name!r}: parameter {p.name!r} sets "
                    f"channel={p.channel!r} but role={p.role!r} — channel "
                    "planes must declare role='channel'")
            if p.batchable:
                batchable.append(p)
                if p.role != "ctx":
                    raise RegistryError(
                        f"program {name!r}: batchable parameter {p.name!r} "
                        "must have role='ctx' (the superstep cap is a "
                        "static jit argument and cannot carry a batch axis)")
            if not p.required:
                # defaults are injected into normalized params verbatim, so
                # they must pass the same dtype/validate gauntlet as caller
                # values — fail HERE, not deep inside a dispatch
                try:
                    p.coerce(name, p.default)
                except RegistryError as e:
                    raise RegistryError(
                        f"program {name!r}: default for parameter "
                        f"{p.name!r} is invalid: {e}") from e
        if len(batchable) > 1:
            names = ", ".join(p.name for p in batchable)
            raise RegistryError(
                f"program {name!r}: at most one batchable parameter is "
                f"supported (the micro-batch axis), got: {names}")
        entry = ProgramEntry(
            name=name, program=program, params=params, cacheable=cacheable,
            resources=tuple(sorted((resources or {}).items())),
            oracle=oracle, oracle_atol=float(oracle_atol))
        self._entries[name] = entry
        return entry

    def unregister(self, name: str) -> None:
        self._entries.pop(name, None)

    def get(self, name: str) -> ProgramEntry:
        entry = self._entries.get(name)
        if entry is None:
            raise UnknownProgramError(
                f"unknown program {name!r}; registered: "
                f"{', '.join(sorted(self._entries)) or '<none>'}")
        return entry

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def names(self) -> list[str]:
        return sorted(self._entries)

    def entries(self) -> list[ProgramEntry]:
        return [self._entries[n] for n in self.names()]


#: The process-wide registry every layer derives from. ``engine.programs``
#: registers the built-ins on import; user programs register through the
#: same public ``register`` call.
DEFAULT_REGISTRY = ProgramRegistry()


def register(name: str, program, params=(), **kwargs) -> ProgramEntry:
    """Register into the default registry (the public extension point)."""
    return DEFAULT_REGISTRY.register(name, program, params, **kwargs)


def unregister(name: str) -> None:
    DEFAULT_REGISTRY.unregister(name)


def get_program(name: str) -> ProgramEntry:
    return DEFAULT_REGISTRY.get(name)


def bind_channel(program: str, param: str, values) -> ChannelValue:
    """Bind a property plane on a default-registry program (the public
    "bound once per epoch" entry point; see ProgramEntry.bind_channel)."""
    return DEFAULT_REGISTRY.get(program).bind_channel(param, values)


def unbind_channel(program: str, param: str) -> None:
    DEFAULT_REGISTRY.get(program).unbind_channel(param)


def program_names() -> list[str]:
    return DEFAULT_REGISTRY.names()

"""Mesh environment: logical-axis helpers shared by model code (the
counterpart of ``repro/sharding/env.py``).

Model code never hard-codes mesh axis names; it asks the active ``MeshEnv``
for sizes and specs. With no env set every helper is a no-op, so the same
model code runs on one device and is counted for the production mesh.

Physical mesh (``launch/mesh.py``):
    single-pod  (data=16, model=16)            axes ("data", "model")
    multi-pod   (pod=2, data=16, model=16)     axes ("pod", "data", "model")

Logical mapping (the reference's):
    batch / sequence-shards -> ("pod", "data")   ["dp"]
    heads / d_ff / experts  -> "model"           ["tp"]
    fsdp param dim          -> "data"            (replicated across pods;
                                                  grads all-reduce over pod)

The mesh is the port's own object, :class:`Mesh`: named axis sizes. An env
of a bare mesh is *active* but not *live*: the dry run
(``launch/dryrun.py``) reads its sizes to pad heads and experts, to split
each argument into its per-device shard (XLA's rule: a dimension split
over axes of total size n holds ceil(dim / n) on every device) and to
price collectives, and the model code runs as on one device.

An env is *live* when it also carries a process group for each axis
(:meth:`Mesh.connect` over a ``torch.distributed`` group of the mesh's
size, one rank a mesh device, row-major as ``init_device_mesh`` lays them
out) and this rank's coordinates. Sharded execution is explicit SPMD: each
rank holds the shard :func:`shard_tensor` cuts of every parameter
(``shard_shape``), computes on local tensors, and the model code calls
``core/collectives.py`` where the reference's specs split a contraction or
a reduction. :func:`shard` stays the identity: on a rank the layout is set
by the parameters' shards and those collectives, not by annotating
activations.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named mesh axes and their sizes, e.g. ``Mesh((16, 16), ("data",
    "model"))``."""
    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"mesh: {len(self.axis_sizes)} sizes for "
                             f"{len(self.axis_names)} axis names")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order (as a JAX mesh's ``shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def make_device_mesh(self, device_type: str = "cuda"):
        """A ``DeviceMesh`` of this shape over the default process group,
        which must be live and of ``size`` ranks."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        if not dist.is_initialized() or dist.get_world_size() != self.size:
            got = dist.get_world_size() if dist.is_initialized() else None
            raise RuntimeError(f"make_device_mesh: mesh {self.axis_sizes} "
                               f"needs a live process group of {self.size} "
                               f"ranks, got {got}")
        return init_device_mesh(device_type, self.axis_sizes,
                                mesh_dim_names=self.axis_names)

    def connect(self, device_type: str = "cuda") -> "Live":
        """This rank's process group and index on every axis, from
        :meth:`make_device_mesh` (every rank of the default group must
        call it, in the same order). Raises unless the default group is
        live and has exactly ``size`` ranks."""
        dm = self.make_device_mesh(device_type)
        return Live(groups={a: dm.get_group(a) for a in self.axis_names},
                    coords={a: int(dm.get_local_rank(a))
                            for a in self.axis_names})


@dataclasses.dataclass(frozen=True)
class Live:
    """A live mesh on this rank: the process group of each axis (the ranks
    that differ from this one only along it) and this rank's index on each
    axis."""
    groups: dict
    coords: dict


@dataclasses.dataclass(frozen=True)
class MeshEnv:
    mesh: Mesh | None = None
    dp: tuple[str, ...] = ()     # batch axes (pod, data)
    fsdp: str | None = None      # param-shard axis (data)
    tp: str | None = None        # tensor axis (model)
    live: Live | None = None     # process groups: sharded execution
    #: whether activations' batch rows are split over dp (False: every dp
    #: rank holds the whole batch, a serving batch smaller than dp)
    batch_split: bool = True

    @property
    def active(self) -> bool:
        return self.mesh is not None

    @property
    def is_live(self) -> bool:
        return self.live is not None

    def group(self, axis: str):
        """The process group of mesh axis ``axis`` (live envs only)."""
        return self.live.groups[axis]

    def index(self, axis: str | None) -> int:
        """This rank's index along mesh axis ``axis`` (0 off a live env or
        for an axis the mesh lacks)."""
        if self.live is None or axis is None:
            return 0
        return self.live.coords.get(axis, 0)

    def tp_index(self) -> int:
        return self.index(self.tp)

    def dp_index(self) -> int:
        """This rank's row block of a dp-split batch: the dp axes' indices,
        row-major (pod, then data)."""
        i = 0
        for a in self.dp:
            i = i * self.mesh.shape[a] + self.index(a)
        return i

    def dp_size(self) -> int:
        if not self.active:
            return 1
        return math.prod(self.mesh.shape[a] for a in self.dp)

    def tp_size(self) -> int:
        return self.mesh.shape[self.tp] if self.active and self.tp else 1

    def fsdp_size(self) -> int:
        return self.mesh.shape[self.fsdp] if self.active and self.fsdp else 1


_local = threading.local()


def set_env(env: MeshEnv) -> None:
    _local.env = env


def get_env() -> MeshEnv:
    return getattr(_local, "env", MeshEnv())


def env_from_mesh(mesh: Mesh | None, live: Live | None = None) -> MeshEnv:
    if mesh is None:
        if live is not None:
            raise ValueError("a live env needs its mesh")
        return MeshEnv()
    names = mesh.axis_names
    dp = tuple(a for a in ("pod", "data") if a in names)
    if live is not None and set(live.groups) != set(names):
        raise ValueError(f"live groups {sorted(live.groups)} for mesh axes "
                         f"{names}")
    return MeshEnv(mesh=mesh,
                   dp=dp,
                   fsdp="data" if "data" in names else None,
                   tp="model" if "model" in names else None,
                   live=live)


class use_mesh:
    """Context manager: activate the MeshEnv of ``mesh`` on this thread;
    with ``live`` (``mesh.connect()``) the env runs sharded. Also takes a
    ready ``MeshEnv`` as ``mesh``."""

    def __init__(self, mesh, live: Live | None = None):
        self.env = mesh if isinstance(mesh, MeshEnv) else env_from_mesh(
            mesh, live)
        self._prev: MeshEnv | None = None

    def __enter__(self):
        self._prev = get_env()
        set_env(self.env)
        return self.env

    def __exit__(self, *exc):
        set_env(self._prev or MeshEnv())
        return False


def shard(x, *spec: Any):
    """Return ``x`` unchanged. The reference constrains ``x`` to the
    logical ``spec`` on the active mesh and lets GSPMD place it; on a live
    env each rank already holds its own block of every activation (its
    batch rows, its heads or channels), set by the parameters' shards and
    the explicit collectives, so there is nothing to constrain."""
    return x


def _resolve(env: MeshEnv, s):
    if s is None:
        return None
    if isinstance(s, tuple):
        out: list[str] = []
        for part in s:
            r = _resolve(env, part)
            if r is None:
                continue
            out.extend(r if isinstance(r, tuple) else (r,))
        return tuple(out) if out else None
    if s == "dp":
        return env.dp if env.dp else None
    if s == "tp":
        return env.tp
    if s == "fsdp":
        return env.fsdp
    return s  # literal mesh axis name


def logical_spec(*spec: Any, env: MeshEnv | None = None
                 ) -> tuple[tuple[str, ...], ...]:
    """The logical ``spec`` resolved on the active env (or ``env``): per
    tensor dimension, the tuple of mesh axes it is split over (empty:
    replicated). With no env active every dimension is replicated."""
    env = get_env() if env is None else env
    out = []
    for s in spec:
        r = _resolve(env, s) if env.active else None
        out.append(() if r is None else r if isinstance(r, tuple) else (r,))
    return tuple(out)


def shard_shape(shape, spec, env: MeshEnv | None = None) -> tuple[int, ...]:
    """The per-device shape of a tensor of ``shape`` split by the logical
    ``spec`` on the active env (or ``env``): ceil(dim / product of the
    sizes of its axes), XLA's rule for an uneven split."""
    env = get_env() if env is None else env
    phys = logical_spec(*spec, env=env)
    if len(phys) != len(shape):
        raise ValueError(f"spec {spec} has {len(phys)} entries for a "
                         f"tensor of shape {tuple(shape)}")
    sizes = env.mesh.shape if env.active else {}
    return tuple(-(-int(d) // math.prod(sizes[a] for a in axes))
                 for d, axes in zip(shape, phys))


def _axes_index(env: MeshEnv, axes: tuple[str, ...]) -> tuple[int, int]:
    """(this rank's index, the count) over ``axes`` taken row-major."""
    i, n = 0, 1
    for a in axes:
        size = env.mesh.shape[a]
        i, n = i * size + env.index(a), n * size
    return i, n


def shard_tensor(t, spec, env: MeshEnv | None = None, halves: bool = False):
    """This rank's shard of the full tensor ``t`` split by the logical
    ``spec`` on the live env (or ``env``): along each split dimension the
    block ``[i·c, (i+1)·c)`` with c = ceil(dim / n) (``shard_shape``), the
    last block zero-padded to c. ``halves``: the last dimension is two
    halves side by side (the SSM's ``in_proj``: x and its gate), each split
    on its own, so a rank holds its channels of both. A new tensor, never
    a view of ``t``."""
    import torch
    env = get_env() if env is None else env
    phys = logical_spec(*spec, env=env)
    if len(phys) != t.ndim:
        raise ValueError(f"spec {spec} has {len(phys)} entries for a "
                         f"tensor of shape {tuple(t.shape)}")
    if halves:
        t = t.unflatten(-1, (2, t.shape[-1] // 2))
        phys = phys[:-1] + ((),) + phys[-1:]
    for dim, axes in enumerate(phys):
        if not axes:
            continue
        i, n = _axes_index(env, axes)
        size = t.shape[dim]
        c = -(-size // n)
        part = t.narrow(dim, min(i * c, size), max(0, min(c, size - i * c)))
        if part.shape[dim] < c:
            pad = list(part.shape)
            pad[dim] = c - part.shape[dim]
            part = torch.cat([part, part.new_zeros(pad)], dim=dim)
        t = part
    if halves:
        t = t.flatten(-2)
    return t.clone(memory_format=torch.contiguous_format)


def gather_tensor(t, spec, full_shape, env: MeshEnv | None = None,
                  halves: bool = False):
    """The inverse of :func:`shard_tensor` on a live env: the full tensor
    of ``full_shape`` from every rank's shard ``t``, all-gathered over the
    group of each split dimension's axis (every rank gets it; every rank
    of the mesh must call it, in the same order)."""
    from ..core import collectives as C
    env = get_env() if env is None else env
    phys = logical_spec(*spec, env=env)
    full = list(full_shape)
    if halves:
        t = t.unflatten(-1, (2, t.shape[-1] // 2))
        phys = phys[:-1] + ((),) + phys[-1:]
        full = full[:-1] + [2, full[-1] // 2]
    for dim, axes in enumerate(phys):
        for a in reversed(axes):      # the innermost axis first: row-major
            t = C.all_gather(t, dim, env.group(a))
        if axes:
            t = t.narrow(dim, 0, full[dim])
    if halves:
        t = t.flatten(-2)
    return t.contiguous()


@dataclasses.dataclass(frozen=True)
class Placement:
    """How a leaf lies on the mesh: its logical ``spec``, its full
    ``shape`` and whether its last dimension is two halves split apart
    (:func:`shard_tensor`). A leaf of a checkpoint's ``shardings=`` tree."""
    spec: tuple
    shape: tuple
    halves: bool = False

    def shard(self, t, env: MeshEnv | None = None):
        """This rank's shard of the full leaf ``t``."""
        if tuple(t.shape) != tuple(self.shape):
            raise ValueError(f"leaf of shape {tuple(t.shape)}, placement "
                             f"for {tuple(self.shape)}")
        return shard_tensor(t, self.spec, env, self.halves)

    def gather(self, t, env: MeshEnv | None = None):
        """The full leaf from every rank's shard (a collective)."""
        return gather_tensor(t, self.spec, self.shape, env, self.halves)


def place(t, spec, halves: bool = False):
    """``t`` as the active env holds it: its shard on a live env
    (:func:`shard_tensor`, and ``t`` is freed by the caller dropping it),
    else ``t`` itself."""
    env = get_env()
    return shard_tensor(t, spec, env, halves) if env.is_live else t

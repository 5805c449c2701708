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

The mesh is the port's own object, :class:`Mesh`: named axis sizes and
nothing else, no devices and no process group. The dry run
(``launch/dryrun.py``) reads the sizes to pad heads and experts, to split
each argument into its per-device shard (XLA's rule: a dimension split
over axes of total size n holds ceil(dim / n) on every device) and to
price collectives. :meth:`Mesh.make_device_mesh` turns the mesh into a
``torch.distributed.device_mesh.DeviceMesh`` over a live process group of
its size, for sharded execution; nothing in the port runs sharded tensors
yet.
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
            raise RuntimeError(f"make_device_mesh: needs a live process group "
                               f"of {self.size} ranks")
        return init_device_mesh(device_type, self.axis_sizes,
                                mesh_dim_names=self.axis_names)


@dataclasses.dataclass(frozen=True)
class MeshEnv:
    mesh: Mesh | None = None
    dp: tuple[str, ...] = ()     # batch axes (pod, data)
    fsdp: str | None = None      # param-shard axis (data)
    tp: str | None = None        # tensor axis (model)

    @property
    def active(self) -> bool:
        return self.mesh is not None

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


def env_from_mesh(mesh: Mesh | None) -> MeshEnv:
    if mesh is None:
        return MeshEnv()
    names = mesh.axis_names
    dp = tuple(a for a in ("pod", "data") if a in names)
    return MeshEnv(mesh=mesh,
                   dp=dp,
                   fsdp="data" if "data" in names else None,
                   tp="model" if "model" in names else None)


class use_mesh:
    """Context manager: activate the MeshEnv of ``mesh`` on this thread."""

    def __init__(self, mesh: Mesh | None):
        self.env = env_from_mesh(mesh)
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
    logical ``spec`` on the active mesh; the port runs no sharded tensors
    yet, so there is nothing to constrain."""
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

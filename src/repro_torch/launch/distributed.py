"""Joining a launcher's process to a live mesh (``launch/train.py`` and
``launch/serve.py`` share it).

Under ``torchrun`` (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT`` set) the process joins the default
process group with the backend asked for, takes the card
``cuda:{LOCAL_RANK % device_count}`` (or the CPU) and connects the mesh,
which must have one device a rank. Nothing falls back: a mesh of another
size than the world raises, and so does a backend the device cannot take
(NCCL refuses two ranks on one card, and the CPU). The CUDA kernels the
run needs are built by rank 0 before the others load them, so no two
``nvcc`` run at once.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..core.graph import resolve_device
from ..sharding.env import Live, Mesh


def join(mesh: Mesh, backend: str, device: str | None = None,
         kernels: tuple[str, ...] = ()) -> tuple[torch.device, Live | None]:
    """(this process's device, its live mesh or None). Without
    ``WORLD_SIZE`` only a mesh of one device runs, not live (the
    one-device path); with it, the process group and the mesh's groups
    are set up as the module says."""
    if "WORLD_SIZE" not in os.environ:
        if mesh.size != 1:
            raise RuntimeError(
                f"mesh {mesh.axis_sizes} needs {mesh.size} processes: run "
                f"under torchrun --nproc-per-node {mesh.size}")
        return resolve_device(device), None
    if device == "cpu":
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu (and "
                               "--backend gloo) to run on the CPU")
        dev = torch.device(
            "cuda", int(os.environ.get("LOCAL_RANK", 0))
            % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend)
    if dev.type == "cuda" and kernels:
        if dist.get_rank() == 0:
            from .. import cuda_build
            cuda_build.build(kernels)
        dist.barrier()
    return dev, mesh.connect(dev.type)


def is_main() -> bool:
    """Whether this process prints: rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def leave() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()

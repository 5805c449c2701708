"""Checkpoints: one ``.npy`` per leaf and a JSON manifest, an asynchronous
writer, atomic publish and resume from the latest (the counterpart of
``repro/ckpt/checkpoint.py``).

The on-disk format is the reference's, so each package restores the
other's checkpoints: a directory ``step-<9 digits>`` holding
``manifest.json`` (``{"step", "leaves": {key: {"file", "shape",
"dtype"}}, "time"}``) and a file per leaf named by its key with "/" as
"__". Keys are the leaf's path: dict keys sorted, tuples (a ``NamedTuple``
such as ``OptState`` too, as the reference's flattening meets the tuple
case first) by index. bfloat16 leaves are stored as their raw 16 bits
(``u2``) under dtype ``"bfloat16"``.

``restore(template, device=...)`` puts the leaves on one device. On a
live mesh (``sharding.env``) both take ``shardings=``, a tree of
``sharding.env.Placement`` in the tree's layout (``lm.placements``; a
scalar's is ``Placement((), ())``): ``save`` gathers each leaf from every
rank's shard and rank 0 alone writes it, so the files are the reference's
full leaves; ``restore`` reads full leaves and keeps this rank's shard,
the reference's elastic re-shard, so a checkpoint written at one mesh
restores at another (or on one device).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from ..core.graph import resolve_device
from ..sharding.env import get_env


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):            # jax.tree's dict-key order
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (tuple, list)):  # NamedTuples land here too
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _unflatten(template, loaded: dict, prefix=""):
    """``template``'s structure with each leaf replaced by
    ``loaded[key]``."""
    if isinstance(template, dict):
        return {k: _unflatten(v, loaded, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        parts = [_unflatten(v, loaded, f"{prefix}{i}/")
                 for i, v in enumerate(template)]
        if hasattr(template, "_fields"):
            return type(template)(*parts)
        return type(template)(parts)
    return loaded[prefix.rstrip("/")]


def _to_host(leaf) -> np.ndarray:
    """A host copy of a leaf (never a view of a tensor the caller may go on
    updating); bfloat16 as its raw bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.array(leaf)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = False,
             shardings: Any = None) -> None:
        """Write ``tree`` as step ``step``. The leaves are copied to host
        memory first; the files are written by a background thread unless
        ``blocking`` (or ``async_write`` is off), never two at once. With
        ``shardings`` (a live mesh) every rank calls it: each leaf is
        gathered whole, rank 0 writes, and all ranks return once the step
        is published."""
        places = None if shardings is None else _flatten(shardings)
        host = {}
        for k, v in _flatten(tree).items():
            if places is not None:
                v = places[k].gather(v)
            bf16 = isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16
            host[k] = (_to_host(v), bf16)
        self.wait()                      # never two writers in flight
        if places is not None and get_env().is_live:
            import torch.distributed as dist
            if dist.get_rank() == 0:
                self._write(step, host)
            dist.barrier()
            return
        if self.async_write and not blocking:
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)

    def _write(self, step: int, host: dict) -> None:
        tmp = os.path.join(self.dir, f".tmp-{step}-{threading.get_ident()}-"
                                     f"{time.time_ns()}")
        final = os.path.join(self.dir, f"step-{step:09d}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {}
        for k, (v, bf16) in host.items():
            fn = k.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fn), v)
            manifest[k] = {"file": fn, "shape": list(v.shape),
                           "dtype": "bfloat16" if bf16 else str(v.dtype)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "leaves": manifest,
                       "time": time.time()}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)            # atomic publish
        self._gc()

    def wait(self) -> None:
        """Block until the background writer, if any, has finished."""
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step-{s:09d}"),
                          ignore_errors=True)

    # -- load ---------------------------------------------------------------
    def all_steps(self) -> list[int]:
        return sorted(int(d.split("-")[1]) for d in os.listdir(self.dir)
                      if d.startswith("step-"))

    def latest_step(self) -> int | None:
        s = self.all_steps()
        return s[-1] if s else None

    def restore(self, template: Any, step: int | None = None,
                device=None, shardings: Any = None) -> Any:
        """The checkpoint of ``step`` (None: the latest) in the structure
        of ``template`` (whose leaves give the expected shapes), as
        tensors of the stored dtypes on ``device`` (None: the card). With
        ``shardings`` (a live mesh) each stored leaf must have its
        placement's full shape, and this rank keeps its shard of it (the
        template's leaves are shards)."""
        dev = resolve_device(device)
        places = None if shardings is None else _flatten(shardings)
        env = get_env()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        base = os.path.join(self.dir, f"step-{step:09d}")
        with open(os.path.join(base, "manifest.json")) as f:
            manifest = json.load(f)["leaves"]
        loaded = {}
        for k, tmpl in _flatten(template).items():
            if k not in manifest:
                raise KeyError(f"checkpoint step {step} has no leaf {k!r}")
            info = manifest[k]
            arr = np.load(os.path.join(base, info["file"]))
            want = tuple(tmpl.shape) if places is None else places[k].shape
            if tuple(arr.shape) != tuple(want):
                raise ValueError(f"checkpoint leaf {k!r}: shape "
                                 f"{tuple(arr.shape)}, expected "
                                 f"{tuple(want)}")
            if info["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            if places is not None:
                t = places[k].shard(t, env)
                if tuple(t.shape) != tuple(tmpl.shape):
                    raise ValueError(f"checkpoint leaf {k!r}: this rank's "
                                     f"shard {tuple(t.shape)}, template "
                                     f"{tuple(tmpl.shape)}")
            loaded[k] = t.to(dev)
        return _unflatten(template, loaded)

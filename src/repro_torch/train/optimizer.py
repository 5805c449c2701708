"""Hand-rolled AdamW, cosine schedule and global-norm clipping (the
counterpart of ``repro/train/optimizer.py``).

Parameters, gradients and the moments are trees of nested dicts of
tensors, the layout of ``models.lm``'s parameters. ``OptState`` is the
reference's: what checkpoints hold and what ``lm.opt_state_from_reference``
carries across. The scalars are computed as the reference computes them:
the step counter int32, ``b ** step`` on a float32 step, and the global
norm summed leaf by leaf in sorted-key order (``jax.tree.leaves``' order).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from ..core import collectives as C
from ..sharding.env import get_env


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


#: Elements of a leaf ``apply_updates`` updates at once (256 MiB of
#: float32).
UPDATE_SLICE = 1 << 26


class OptState(NamedTuple):
    step: torch.Tensor      # int32 scalar: updates applied so far
    m: Any
    v: Any


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest``: trees of the same
    keys, passed beside each leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, keys in sorted order (as
    ``jax.tree.leaves`` orders a dict)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_pick(tree, i: int):
    """Element ``i`` of each (tuple) leaf of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_pick(v, i) for k, v in tree.items()}
    return tree[i]


def init_opt_state(params) -> OptState:
    """Step 0 and zero moments shaped and typed as ``params``, on their
    devices."""
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return OptState(step, tree_map(torch.zeros_like, params),
                    tree_map(torch.zeros_like, params))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up over ``warmup_steps``, then a cosine down to
    ``min_lr_frac`` of ``lr`` at ``total_steps``: float32 of an int
    ``step`` tensor."""
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def global_norm(tree, split=None) -> torch.Tensor:
    """√Σ g², float32, the leaves summed in sorted-key order. On a live
    mesh ``split`` gives the mesh axes each leaf's shards are split over
    (``train_step.split_axes``; none for every leaf by default): the
    squares of the leaves split alike are summed over those axes' groups,
    and a leaf replicated over an axis is counted once."""
    leaves = tree_leaves(tree)
    axes_of = tree_leaves(split) if split is not None else [()] * len(leaves)
    buckets: dict = {}
    for leaf, axes in zip(leaves, axes_of):
        buckets[axes] = buckets.get(axes, 0) + torch.sum(
            torch.square(leaf.float()))
    total = 0
    for axes in sorted(buckets):
        part = buckets[axes].clone()
        for a in axes:
            C.all_reduce_(part, "sum", get_env().group(a))
        total = total + part
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state: OptState,
                  split=None):
    """One AdamW step, gradients clipped to ``grad_clip`` global norm
    (``split``: on a live mesh, as ``global_norm`` takes it).
    Returns (new params in their own dtypes, new OptState, {"grad_norm",
    "lr"}); the inputs are left as they were. Each leaf is updated in
    slices of at most UPDATE_SLICE elements along its first axis, written
    into its new tensors, so the update's temporaries stay small beside
    the state (a stacked leaf of a large model holds gigabytes); the
    arithmetic is elementwise, so slicing changes no bit."""
    gnorm = global_norm(grads, split)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m / b1c
        vh = v / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p
        return (p - lr * delta).to(p.dtype), m, v

    def sliced(p, g, m, v):
        if p.ndim == 0 or p.numel() <= UPDATE_SLICE:
            return upd(p, g, m, v)
        out = (torch.empty_like(p), torch.empty_like(m),
               torch.empty_like(v))
        rows = max(1, UPDATE_SLICE * p.shape[0] // p.numel())
        for i in range(0, p.shape[0], rows):
            part = slice(i, i + rows)
            for o, new in zip(out, upd(p[part], g[part], m[part], v[part])):
                o[part] = new
        return out

    out = tree_map(sliced, params, grads, state.m, state.v)
    return tree_pick(out, 0), OptState(step, tree_pick(out, 1),
                                       tree_pick(out, 2)), {
        "grad_norm": gnorm, "lr": lr}

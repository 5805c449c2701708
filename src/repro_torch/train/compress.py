"""Gradient compression with error feedback (the counterpart of
``repro/train/compress.py``).

int8 block-quantised gradients with error feedback cut the traffic of a
data-parallel all-reduce 4× against float32. The codec is a pure function
and a carried error state, so it drops into a train step as a gradient
transform:

    g_q, err = ef_compress(g + err_prev)        # quantise what we can,
    g_synced = all_reduce(decompress(g_q))      # carry what we cannot

``torch.round`` and ``jnp.round`` both round half to even, so the codec
gives the reference's bits.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .optimizer import tree_leaves, tree_map, tree_pick

BLOCK = 256


class Compressed(NamedTuple):
    q: torch.Tensor          # int8 payload [n_blocks, BLOCK]
    scale: torch.Tensor      # float32 per-block scales [n_blocks]


def compress(x: torch.Tensor) -> Compressed:
    """Symmetric int8 block quantisation of a float tensor (any shape),
    BLOCK values a block, zero-padded."""
    flat = x.float().reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    flat = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(flat), dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(flat / torch.clamp(scale, min=1e-12)),
                    -127, 127).to(torch.int8)
    return Compressed(q, scale[:, 0])


def decompress(c: Compressed, shape: tuple, dtype=torch.float32
               ) -> torch.Tensor:
    flat = c.q.float() * c.scale[:, None]
    n = 1
    for d in shape:
        n *= d
    return flat.reshape(-1)[:n].reshape(shape).to(dtype)


def ef_compress_tree(grads: Any, err: Any) -> tuple[Any, Any, Any]:
    """Error-feedback compression over a gradient tree.

    Returns (decompressed gradients to feed the optimizer or all-reduce,
    the new error state, the compressed payloads for transport)."""
    def one(g, e):
        corrected = g.float() + e
        c = compress(corrected)
        d = decompress(c, tuple(g.shape))
        return d, corrected - d, c

    outs = tree_map(one, grads, err)
    return tuple(tree_pick(outs, i) for i in range(3))


def init_error_state(grads_template: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_template)


def compression_ratio(grads: Any) -> float:
    """float32 bytes / compressed bytes for a gradient tree."""
    leaves = tree_leaves(grads)
    f32 = sum(g.numel() * 4 for g in leaves)
    comp = sum(g.numel() * 1 + (g.numel() // BLOCK + 1) * 4 for g in leaves)
    return f32 / comp

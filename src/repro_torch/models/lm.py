"""Decoder-only language model over the port's layers (the counterpart of
``repro/models/lm.py``; the ``ssm`` family so far).

Layout of ``params`` (the reference's, so that carrying weights across is
a copy, never a transpose):
  embed      [V_pad, D]
  blocks     {"l0": ..., "l{P-1}": ...}  — each leaf stacked [R, ...]
  final_norm [D];  lm_head [V_pad, D] (absent if tied)

Caches (decode), per pattern position, stacked [R, ...]:
  ssm -> (conv [R, B, K-1, Di] bf16, h [R, B, Di, N] f32)

Layers run as a Python loop over the R repeats: the port has no ``scan``
to lower, and each layer's selective scan is one kernel launch.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.graph import resolve_device
from . import layers as L
from . import ssm as S

#: Families ``forward_lm``, ``decode_step`` and ``init_params`` run.
PORTED_FAMILIES = ("ssm",)


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported to repro_torch "
            f"yet (see ROADMAP.md, queue 1 item 15); ported: "
            f"{', '.join(PORTED_FAMILIES)}")


def vocab_pad(cfg: ModelConfig) -> int:
    return L.pad_to(cfg.vocab, 128)


def param_shapes(cfg: ModelConfig) -> dict[str, Any]:
    """The shape of every parameter, in the layout of ``params``."""
    _require_ported(cfg)
    r, d, vp = cfg.block_repeats, cfg.d_model, vocab_pad(cfg)
    blocks = {}
    for i in range(len(cfg.layer_pattern)):
        mixer = {k: (r,) + v for k, v in S.param_shapes(cfg).items()}
        blocks[f"l{i}"] = {"norm1": (r, d), "mixer": mixer}
    shapes = {"embed": (vp, d), "blocks": blocks, "final_norm": (d,)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (vp, d)
    return shapes


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict[str, Any]:
    """Random parameters with the reference init's distributions, float32,
    drawn from ``generator`` on ``device`` (None: the card). ``jax.random``
    streams cannot be reproduced, so the values differ from the
    reference's for the same seed; ``params_from_reference`` carries the
    reference's own values across."""
    _require_ported(cfg)
    dev = resolve_device(device)
    r = cfg.block_repeats
    params: dict[str, Any] = {
        "embed": L._init(generator, (vocab_pad(cfg), cfg.d_model),
                         device=dev)}
    blocks = {}
    for i in range(len(cfg.layer_pattern)):
        blocks[f"l{i}"] = {
            "norm1": torch.ones((r, cfg.d_model), dtype=L.PARAM_DTYPE,
                                device=dev),
            "mixer": S.init_ssm(cfg, generator, r, dev)}
    params["blocks"] = blocks
    params["final_norm"] = torch.ones(cfg.d_model, dtype=L.PARAM_DTYPE,
                                      device=dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = L._init(generator,
                                    (vocab_pad(cfg), cfg.d_model),
                                    device=dev)
    return params


def params_from_reference(cfg: ModelConfig, np_params, device=None
                          ) -> dict[str, Any]:
    """The reference's params pytree (numpy leaves, or anything
    ``np.asarray`` takes) as the port's parameters, float32 on ``device``.
    Every leaf must be present with the shape ``param_shapes`` gives; extra
    leaves raise too."""
    dev = resolve_device(device)

    def walk(shapes, tree, path):
        if isinstance(shapes, dict):
            if not isinstance(tree, dict) or set(tree) != set(shapes):
                got = sorted(tree) if isinstance(tree, dict) else type(tree)
                raise ValueError(f"params{path}: expected keys "
                                 f"{sorted(shapes)}, got {got}")
            return {k: walk(shapes[k], tree[k], f"{path}/{k}")
                    for k in shapes}
        arr = np.asarray(tree, dtype=np.float32)
        if arr.shape != tuple(shapes):
            raise ValueError(f"params{path}: shape {arr.shape}, expected "
                             f"{tuple(shapes)}")
        return torch.tensor(arr, device=dev)

    return walk(param_shapes(cfg), np_params, "")


def params_to_numpy(params) -> dict[str, Any]:
    """The parameters as a pytree of numpy arrays (the reference's
    layout)."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return params.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def _apply_layer(cfg: ModelConfig, p: dict, x: torch.Tensor, cache=None):
    """Pre-norm residual SSM layer. Returns (x, new_cache)."""
    h = L.rms_norm(x, p["norm1"], cfg.rms_eps)
    y, new_cache = S.ssm_block(cfg, p["mixer"], h, state=cache)
    return x + y, new_cache


def _run_blocks(cfg: ModelConfig, blocks: dict, x: torch.Tensor, *,
                caches=None, collect_cache: bool = False):
    """The R repeated blocks in order. Returns (x, new caches | None), the
    caches stacked [R, ...] as the reference's scan stacks them."""
    pattern = cfg.layer_pattern
    keep = caches is not None or collect_cache
    per_layer: dict[str, list] = {f"l{i}": [] for i in range(len(pattern))}
    for r in range(cfg.block_repeats):
        for i in range(len(pattern)):
            name = f"l{i}"
            p = _index(blocks[name], r)
            c = None if caches is None else tuple(t[r] for t in caches[name])
            x, nc = _apply_layer(cfg, p, x, c)
            if keep:
                per_layer[name].append(nc)
    if not keep:
        return x, None
    return x, {name: tuple(torch.stack(parts) for parts in zip(*layer))
               for name, layer in per_layer.items()}


def _index(tree, r: int):
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


def _logits(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = L.rms_norm(x, params["final_norm"], cfg.rms_eps)
    head = params.get("lm_head", params["embed"])
    return x.to(L.COMPUTE_DTYPE) @ head.to(L.COMPUTE_DTYPE).T


def _embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    # index, then cast: the same bits as casting the table first
    return params["embed"][tokens].to(L.COMPUTE_DTYPE)


def forward_lm(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
               collect_cache: bool = False):
    """Full-sequence forward (prefill). tokens [B, S] int.
    Returns (logits [B, S, V_pad] bf16, aux (0.0: no MoE loss), caches if
    ``collect_cache`` else None)."""
    _require_ported(cfg)
    x, caches = _run_blocks(cfg, params["blocks"], _embed(params, tokens),
                            collect_cache=collect_cache)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(cfg, params, x), aux, caches


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor, caches,
                cache_len: int):
    """One decode step. token [B, 1] int; ``cache_len`` is the current
    prefix length (the SSM state does not read it). Returns
    (logits [B, 1, V_pad], new caches); ``caches`` is left as it was."""
    _require_ported(cfg)
    x, new_caches = _run_blocks(cfg, params["blocks"], _embed(params, token),
                                caches=caches)
    return _logits(cfg, params, x), new_caches


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def cache_struct(cfg: ModelConfig, batch: int, s_max: int):
    """{"l{i}": ((shape, dtype), ...)} of the decode caches; for each
    tensor also the axis of its sequence (None if it has none), so that a
    server grows by kind, never by matching shapes. SSM state has no
    sequence axis: (conv [R, B, K-1, Di] bf16, h [R, B, Di, N] f32)."""
    _require_ported(cfg)
    r = cfg.block_repeats
    s_cfg, d_in, _ = S.ssm_dims(cfg)
    out = {}
    for i in range(len(cfg.layer_pattern)):
        out[f"l{i}"] = (
            ((r, batch, s_cfg.d_conv - 1, d_in), torch.bfloat16, None),
            ((r, batch, d_in, s_cfg.d_state), torch.float32, None))
    return out

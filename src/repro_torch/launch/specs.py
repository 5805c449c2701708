"""input_specs(): ``meta`` stand-ins and logical spec trees for every
(arch × shape) cell (the counterpart of ``repro/launch/specs.py``).

A stand-in is a tensor on ``torch.device("meta")``: it has a shape and a
dtype and no storage, so a production-size step runs on it without
allocating anything. Stand-ins are built from the shape functions
(``lm.param_shapes``, ``lm.cache_struct``, ``lm.cross_kv_struct``), never
from ``init_params``: a ``torch.Generator`` does not draw on ``meta``.
Shapes and specs read the active mesh (``sharding.use_mesh``), as the
reference's do.
"""
from __future__ import annotations

from typing import Any

import torch

from ..configs import get_config
from ..configs.base import SHAPES, ModelConfig, ShapeConfig
from ..models import lm
from ..models.layers import PARAM_DTYPE
from ..models.perf import get_perf
from ..sharding.env import get_env, shard_shape
from ..train.optimizer import OptState, tree_map

META = torch.device("meta")


def _sd(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> str | None:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("full-attention arch: 524k-token decode requires "
                "sub-quadratic attention")
    return None


def leaves_with_specs(structs, specs):
    """(tensor, logical spec) for every tensor of ``structs``, walking
    ``specs`` along the same path (dicts by key, tuples and ``OptState``
    by position)."""
    if isinstance(structs, torch.Tensor):
        yield structs, specs
    elif isinstance(structs, dict):
        for k in structs:
            yield from leaves_with_specs(structs[k], specs[k])
    else:
        if len(structs) != len(specs):
            raise ValueError(f"{len(structs)} structs against "
                             f"{len(specs)} specs")
        for t, s in zip(structs, specs):
            yield from leaves_with_specs(t, s)


def shard_bytes(structs, specs) -> int:
    """The bytes one device holds of ``structs`` split by ``specs`` on the
    active mesh (XLA's rule: ceil(dim / product of its axes' sizes))."""
    total = 0
    for t, spec in leaves_with_specs(structs, specs):
        n = 1
        for d in shard_shape(t.shape, spec):
            n *= d
        total += n * t.element_size()
    return total


def param_structs(cfg: ModelConfig):
    """(float32 ``meta`` tree in the layout of ``params``, logical spec
    tree)."""
    def walk(shapes):
        if isinstance(shapes, dict):
            return {k: walk(v) for k, v in shapes.items()}
        return _sd(shapes, PARAM_DTYPE)
    return walk(lm.param_shapes(cfg)), lm.param_specs(cfg)


def batch_structs(cfg: ModelConfig, shape: ShapeConfig):
    """Training/prefill batch stand-ins: int32 tokens and labels over the
    text positions; vlm's image embeddings, encdec's audio frames, bf16."""
    b = shape.global_batch
    s = shape.seq_len
    s_text = s - (cfg.n_img_tokens if cfg.family == "vlm" else 0)
    structs: dict[str, Any] = {
        "tokens": _sd((b, s_text), torch.int32),
        "labels": _sd((b, s_text), torch.int32),
    }
    specs: dict[str, Any] = {
        "tokens": ("dp", None),
        "labels": ("dp", None),
    }
    if cfg.family == "vlm":
        structs["img_embeds"] = _sd((b, cfg.n_img_tokens, cfg.d_model),
                                    torch.bfloat16)
        specs["img_embeds"] = ("dp", None, None)
    if cfg.family == "encdec":
        structs["enc_frames"] = _sd((b, cfg.enc_seq, cfg.d_model),
                                    torch.bfloat16)
        specs["enc_frames"] = ("dp", None, None)
    return structs, specs


def cache_structs(cfg: ModelConfig, batch: int, s_max: int):
    """(decode-cache stand-ins, their logical specs)."""
    structs = {name: tuple(_sd(shape, dtype) for shape, dtype, _ in layer)
               for name, layer in lm.cache_struct(cfg, batch, s_max).items()}
    return structs, lm.cache_specs(cfg, batch)


def cross_structs(cfg: ModelConfig, batch: int):
    """(encdec cross k/v stand-ins, their logical specs)."""
    structs = {name: tuple(_sd(shape, dtype) for shape, dtype, _ in layer)
               for name, layer in lm.cross_kv_struct(cfg, batch).items()}
    return structs, lm.cross_kv_specs(cfg, batch)


def _drop_fsdp(specs):
    if isinstance(specs, dict):
        return {k: _drop_fsdp(v) for k, v in specs.items()}
    return tuple(None if part == "fsdp" else part for part in specs)


def input_specs(arch: str, shape_name: str, *, cfg: ModelConfig | None = None,
                shape: ShapeConfig | None = None) -> dict:
    """Everything the dry run needs for one cell: {"cfg", "shape", "skip"}
    and, unless skipped, (stand-ins, specs) pairs under "params" and, by
    the shape's kind, "batch" and "opt" (train), "batch" (prefill), or
    "token", "caches", "cache_len" (an int32 scalar) and, for encdec,
    "cross" (decode). ``cfg`` and ``shape`` replace the registry's config
    and ``SHAPES[shape_name]``."""
    cfg = get_config(arch) if cfg is None else cfg
    shape = SHAPES[shape_name] if shape is None else shape
    reason = skip_reason(cfg, shape)
    if reason:
        return {"skip": reason, "cfg": cfg, "shape": shape}

    p_structs, p_specs = param_structs(cfg)
    env = get_env()

    if shape.kind != "train":
        perf = get_perf()
        if perf.serve_bf16:   # serve in bf16 (halves weight traffic)
            p_structs = tree_map(
                lambda t: _sd(t.shape, torch.bfloat16)
                if t.is_floating_point() else t, p_structs)
        if perf.serve_replicate_dp_below_gb > 0:
            # replicate weights across dp when the tp-split copy fits:
            # removes the per-layer fsdp all-gathers from the decode path,
            # where the batch cannot split over dp and the arch has
            # attention (the reference's rule)
            total = sum(t.numel() * t.element_size()
                        for t, _ in leaves_with_specs(p_structs, p_specs))
            per_dev_gb = total / max(env.tp_size(), 1) / 2**30
            has_attn = ("attn" in cfg.layer_pattern) or cfg.mla is not None
            small_batch = shape.global_batch < max(env.dp_size(), 1)
            if (per_dev_gb <= perf.serve_replicate_dp_below_gb
                    and has_attn and small_batch):
                p_specs = _drop_fsdp(p_specs)

    out = {"cfg": cfg, "shape": shape, "skip": None,
           "params": (p_structs, p_specs)}

    if shape.kind == "train":
        out["batch"] = batch_structs(cfg, shape)
        out["opt"] = (OptState(_sd((), torch.int32),
                               tree_map(lambda t: _sd(t.shape, t.dtype),
                                        p_structs),
                               tree_map(lambda t: _sd(t.shape, t.dtype),
                                        p_structs)),
                      OptState((), p_specs, p_specs))
    elif shape.kind == "prefill":
        b_structs, b_specs = batch_structs(cfg, shape)
        del b_structs["labels"], b_specs["labels"]
        out["batch"] = (b_structs, b_specs)
    else:  # decode
        b = shape.global_batch
        dp = env.dp_size()
        out["token"] = (_sd((b, 1), torch.int32),
                        ("dp" if b >= dp and b % max(dp, 1) == 0 and dp > 1
                         else None, None))
        out["caches"] = cache_structs(cfg, b, shape.seq_len)
        out["cache_len"] = (_sd((), torch.int32), ())
        if cfg.family == "encdec":
            out["cross"] = cross_structs(cfg, b)
    return out

"""Language models over the port's layers (the counterpart of
``repro/models/lm.py``): the decoder-only ``ssm`` (falcon-mamba-7b),
``hybrid`` (jamba-v0.1-52b), ``dense`` (qwen3-0.6b, qwen2-1.5b,
granite-3-2b, qwen3-4b) and ``moe`` (qwen2-moe-a2.7b; deepseek-v2-236b
with MLA) families, the ``encdec`` family (whisper-small: an encoder over
stub audio-frame embeddings, a decoder that cross-attends to its output)
and the ``vlm`` family (llava-next-34b: stub image-patch embeddings
prepended to the text).

Layout of ``params`` (the reference's, so that carrying weights across is
a copy, never a transpose):
  embed      [V_pad, D]
  blocks     {"l0": ..., "l{P-1}": ...}  — each leaf stacked [R, ...]:
             norm1, mixer (attention, MLA or SSM), norm_x + cross
             (attention; encdec only), and norm2 + ffn (MLP or MoE) where
             the layer has an FFN
  enc_blocks {"l0": ...} (encdec only) — attention and a dense MLP, each
             leaf stacked [n_enc_layers, ...];  enc_final_norm [D]
  final_norm [D];  lm_head [V_pad, D] (absent if tied)

Caches (decode), per pattern position, stacked [R, ...]:
  attn -> (k [R, B, S, KV, dh] bf16, v [R, B, S, KV, dh] bf16)
  mla  -> (c_kv [R, B, S, kv_lora] bf16, k_rope [R, B, S, dr] bf16)
  ssm  -> (conv [R, B, K-1, Di] bf16, h [R, B, Di, N] f32)
Cross k/v (encdec decode), computed once from the encoder's output:
  (k [R, B, S_enc, KV, dh] bf16, v [R, B, S_enc, KV, dh] bf16)

Layers run as a Python loop over the R repeats: the port has no ``scan``
to lower, and each layer's selective scan is one kernel launch.

Shapes read the active mesh (``sharding.env.get_env()``) as the
reference's do: heads and experts are padded to its tp, and
``param_specs``, ``cache_specs`` and ``cross_kv_specs`` give the logical
partition spec trees the reference's ``init_params``, ``cache_struct``
and ``cross_kv_struct`` return beside their shapes. With no mesh active
every shape is the one-device shape.

On a live mesh (``sharding.env.use_mesh(mesh, mesh.connect())``: one
rank a mesh device) the same functions run sharded. Every parameter is
held as this rank's shard (``placements``: ``shard_shape`` of its spec;
``init_params`` draws each leaf whole from the seeded generator and keeps
its shard, ``shard_params`` / ``gather_params`` cut and join a tree). A
leaf split over fsdp is all-gathered just before its layer runs
(``collectives.gather_shard``, inside the layer's remat region, so the
recompute gathers again) and its gradient reduce-scattered back. The
embedding is vocabulary-parallel (a masked lookup of this rank's rows,
all-reduced over tp), the logits this rank's vocabulary columns
(``gather_vocab`` joins them), and every block a tensor-parallel region
(``models/layers.py``, ``models/ssm.py``). Activations hold this rank's
batch rows; attention caches the kv heads its q heads read, MLA caches
the whole latent, SSM state its channels.
"""
from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ModelConfig
from ..core import collectives as C
from ..core.graph import resolve_device
from ..sharding.env import Placement, get_env, logical_spec, place, set_env
from ..train.optimizer import OptState, tree_map
from . import layers as L
from . import ssm as S
from .perf import get_perf, set_perf

#: Families ``forward_lm``, ``decode_step`` and ``init_params`` run.
PORTED_FAMILIES = ("ssm", "hybrid", "dense", "moe", "encdec", "vlm")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported to repro_torch "
            f"yet (see ROADMAP.md, queue 1, \"Modules to port\"); ported: "
            f"{', '.join(PORTED_FAMILIES)}")


def vocab_pad(cfg: ModelConfig) -> int:
    return L.pad_to(cfg.vocab, 128)


def _layer_shapes(cfg: ModelConfig, kind: str, pos: int, *,
                  cross: bool = False, encoder: bool = False
                  ) -> dict[str, Any]:
    r = cfg.n_enc_layers if encoder else cfg.block_repeats
    d = cfg.d_model

    def stack(shapes):
        return {k: stack(v) if isinstance(v, dict) else (r,) + v
                for k, v in shapes.items()}

    out: dict[str, Any] = {"norm1": (r, d)}
    out["mixer"] = stack(S.param_shapes(cfg) if kind == "ssm"
                         else L.mla_shapes(cfg) if cfg.mla is not None
                         else L.attention_shapes(cfg))
    if cross:
        out["norm_x"] = (r, d)
        out["cross"] = stack(L.attention_shapes(cfg))
    fk = "dense" if encoder else cfg.ffn_kind(pos)
    if fk != "none":
        out["norm2"] = (r, d)
        out["ffn"] = stack(L.moe_shapes(cfg) if fk == "moe"
                           else L.mlp_shapes(cfg))
    return out


def param_shapes(cfg: ModelConfig) -> dict[str, Any]:
    """The shape of every parameter, in the layout of ``params``."""
    _require_ported(cfg)
    d, vp = cfg.d_model, vocab_pad(cfg)
    cross = cfg.family == "encdec"
    blocks = {f"l{i}": _layer_shapes(cfg, kind, i, cross=cross)
              for i, kind in enumerate(cfg.layer_pattern)}
    shapes = {"embed": (vp, d), "blocks": blocks, "final_norm": (d,)}
    if cross:
        shapes["enc_blocks"] = {"l0": _layer_shapes(cfg, "attn", 0,
                                                    encoder=True)}
        shapes["enc_final_norm"] = (d,)
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (vp, d)
    return shapes


def _layer_specs(cfg: ModelConfig, kind: str, pos: int, *,
                 cross: bool = False, encoder: bool = False
                 ) -> dict[str, Any]:
    """``_layer_shapes``' logical specs: each leaf's spec with a leading
    None for the repeat axis, which is never split."""
    def stack(specs):
        return {k: stack(v) if isinstance(v, dict) else (None,) + v
                for k, v in specs.items()}

    out: dict[str, Any] = {"norm1": (None, None)}
    out["mixer"] = stack(S.param_specs(cfg) if kind == "ssm"
                         else L.mla_specs(cfg) if cfg.mla is not None
                         else L.attention_specs(cfg))
    if cross:
        out["norm_x"] = (None, None)
        out["cross"] = stack(L.attention_specs(cfg))
    fk = "dense" if encoder else cfg.ffn_kind(pos)
    if fk != "none":
        out["norm2"] = (None, None)
        out["ffn"] = stack(L.moe_specs(cfg) if fk == "moe"
                           else L.mlp_specs())
    return out


def param_specs(cfg: ModelConfig) -> dict[str, Any]:
    """The logical partition spec of every parameter, in the layout of
    ``params``: a tuple per leaf of None (replicated), "tp", "fsdp" or
    "dp" per dimension, the reference's ``init_params`` specs."""
    _require_ported(cfg)
    cross = cfg.family == "encdec"
    blocks = {f"l{i}": _layer_specs(cfg, kind, i, cross=cross)
              for i, kind in enumerate(cfg.layer_pattern)}
    specs: dict[str, Any] = {"embed": ("tp", "fsdp"), "blocks": blocks,
                             "final_norm": (None,)}
    if cross:
        specs["enc_blocks"] = {"l0": _layer_specs(cfg, "attn", 0,
                                                  encoder=True)}
        specs["enc_final_norm"] = (None,)
    if not cfg.tie_embeddings:
        specs["lm_head"] = ("tp", "fsdp")
    return specs


def _init_layer(cfg: ModelConfig, kind: str, pos: int,
                generator: torch.Generator, dev, *, cross: bool = False,
                encoder: bool = False) -> dict[str, Any]:
    """One pattern position's layers, each leaf stacked [R, ...] (R =
    ``n_enc_layers`` for the encoder): the mixer, under ``cross`` a
    cross-attention block, and the FFN, always dense under ``encoder``."""
    r = cfg.n_enc_layers if encoder else cfg.block_repeats
    d = cfg.d_model
    p: dict[str, Any] = {
        "norm1": torch.ones((r, d), dtype=L.PARAM_DTYPE, device=dev)}
    if kind == "ssm":
        p["mixer"] = S.init_ssm(cfg, generator, r, dev)
    elif cfg.mla is not None:
        p["mixer"] = L.init_mla(cfg, generator, r, dev)
    else:
        p["mixer"] = L.init_attention(cfg, generator, r, dev)
    if cross:
        p["norm_x"] = torch.ones((r, d), dtype=L.PARAM_DTYPE, device=dev)
        p["cross"] = L.init_attention(cfg, generator, r, dev)
    fk = "dense" if encoder else cfg.ffn_kind(pos)
    if fk != "none":
        p["norm2"] = torch.ones((r, d), dtype=L.PARAM_DTYPE, device=dev)
        p["ffn"] = (L.init_moe(cfg, generator, r, dev) if fk == "moe"
                    else L.init_mlp(cfg, generator, r, dev))
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict[str, Any]:
    """Random parameters with the reference init's distributions, float32,
    drawn from ``generator`` on ``device`` (None: the card). ``jax.random``
    streams cannot be reproduced, so the values differ from the
    reference's for the same seed; ``params_from_reference`` carries the
    reference's own values across. On a live mesh every leaf is drawn
    whole, in the same order, and cut to this rank's shard before the
    next is drawn, so every mesh starts from the same weights."""
    _require_ported(cfg)
    dev = resolve_device(device)
    params: dict[str, Any] = {
        "embed": place(L._init(generator, (vocab_pad(cfg), cfg.d_model),
                               device=dev), ("tp", "fsdp"))}
    cross = cfg.family == "encdec"
    params["blocks"] = {f"l{i}": _init_layer(cfg, kind, i, generator, dev,
                                             cross=cross)
                        for i, kind in enumerate(cfg.layer_pattern)}
    if cross:
        params["enc_blocks"] = {"l0": _init_layer(cfg, "attn", 0, generator,
                                                  dev, encoder=True)}
        params["enc_final_norm"] = torch.ones(cfg.d_model,
                                              dtype=L.PARAM_DTYPE, device=dev)
    params["final_norm"] = torch.ones(cfg.d_model, dtype=L.PARAM_DTYPE,
                                      device=dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = place(L._init(generator,
                                          (vocab_pad(cfg), cfg.d_model),
                                          device=dev), ("tp", "fsdp"))
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


def placements(cfg: ModelConfig) -> dict[str, Any]:
    """Each parameter's ``Placement`` (spec, full shape, halves), in the
    layout of ``params``, on the active env."""
    def walk(shapes, specs, key=""):
        if isinstance(shapes, dict):
            return {k: walk(shapes[k], specs[k], k) for k in shapes}
        return Placement(tuple(specs), tuple(shapes),
                         halves=key in S.param_halves)
    return walk(param_shapes(cfg), param_specs(cfg))


def shard_params(cfg: ModelConfig, params) -> dict[str, Any]:
    """This rank's shard of every leaf of the full tree ``params`` on the
    live env (``placements``)."""
    return tree_map(lambda pl, t: pl.shard(t), placements(cfg), params)


def gather_params(cfg: ModelConfig, params) -> dict[str, Any]:
    """The full tree from every rank's shards (the inverse of
    ``shard_params``; a collective every rank calls)."""
    return tree_map(lambda pl, t: pl.gather(t), placements(cfg), params)


def params_to_numpy(params) -> dict[str, Any]:
    """The parameters as a pytree of numpy arrays (the reference's
    layout)."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return params.detach().cpu().numpy()


def opt_state_from_reference(cfg: ModelConfig, np_opt, device=None):
    """The reference's ``OptState(step, m, v)`` (numpy leaves, or anything
    ``np.asarray`` takes) as the port's ``train.optimizer.OptState`` on
    ``device``: the step an int32 scalar, the moments float32 in the
    layout of ``params_from_reference``."""
    from ..train.optimizer import OptState
    step, m, v = np_opt
    dev = resolve_device(device)
    return OptState(torch.tensor(np.asarray(step, dtype=np.int32),
                                 device=dev),
                    params_from_reference(cfg, m, dev),
                    params_from_reference(cfg, v, dev))


def state_placements(cfg: ModelConfig) -> dict[str, Any]:
    """``{"params", "opt"}`` placements of a training state (a
    checkpoint's ``shardings=``): the parameters' and both moments',
    the step replicated."""
    pl = placements(cfg)
    return {"params": pl, "opt": OptState(Placement((), ()), pl, pl)}


def opt_state_to_numpy(opt) -> tuple:
    """The port's ``OptState`` as (step, m, v) of numpy arrays, the
    reference's ``OptState`` fields in order."""
    step, m, v = opt
    return (step.detach().cpu().numpy(), params_to_numpy(m),
            params_to_numpy(v))


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def _apply_layer(cfg: ModelConfig, kind: str, pos: int, p: dict,
                 x: torch.Tensor, *, positions, cache=None, cache_len=None,
                 memory=None, cross_kv=None, causal: bool = True,
                 encoder: bool = False):
    """Pre-norm residual layer: the mixer, then cross-attention where the
    layer has it (over ``memory``, the encoder's output, in a prefill;
    over the precomputed ``cross_kv`` in decode), then the FFN where the
    layer has one (an MoE where ``cfg.moe_at(pos)``, never under
    ``encoder``: ``pos`` is the layer's position in the pattern, not its
    global index, as in the reference). Returns (x, new_cache, aux)."""
    h = L.rms_norm(x, p["norm1"], cfg.rms_eps)
    if kind == "ssm":
        y, new_cache = S.ssm_block(cfg, p["mixer"], h, state=cache)
    elif cfg.mla is not None:
        y, new_cache = L.mla_attention(cfg, p["mixer"], h,
                                       positions=positions, cache=cache,
                                       cache_len=cache_len)
    else:
        y, new_cache = L.attention(cfg, p["mixer"], h, positions=positions,
                                   causal=causal, cache=cache,
                                   cache_len=cache_len)
    x = x + y
    if "cross" in p:
        hx = L.rms_norm(x, p["norm_x"], cfg.rms_eps)
        if memory is not None:       # prefill: its k/v cache is dropped
            y, _ = L.attention(cfg, p["cross"], hx, positions=positions,
                               causal=False, kv_input=memory,
                               use_rope=False)
        elif cross_kv is not None:   # decode: the precomputed k/v
            y = L.attention_fixed_kv(cfg, p["cross"], hx, *cross_kv)
        else:
            raise ValueError(f"{cfg.name}: a cross-attention layer needs "
                             "enc_frames (prefill) or cross_kvs (decode)")
        x = x + y
    aux = None
    if "ffn" in p:
        h2 = L.rms_norm(x, p["norm2"], cfg.rms_eps)
        if not encoder and cfg.moe_at(pos):
            y2, aux = L.moe(cfg, p["ffn"], h2)
        else:
            y2 = L.mlp(p["ffn"], h2)
        x = x + y2
    return x, new_cache, aux


def _run_blocks(cfg: ModelConfig, blocks: dict, x: torch.Tensor, *,
                positions, caches=None, cache_len=None, memory=None,
                cross_kvs=None, causal: bool = True, encoder: bool = False,
                collect_cache: bool = False, remat: bool = False):
    """The repeated blocks in order (as many repeats as ``blocks``' leaves
    stack: ``cfg.block_repeats``, or ``n_enc_layers`` for the encoder,
    whose pattern is one attention layer). ``caches`` and ``cross_kvs``
    are indexed per repeat. Returns (x, new caches | None, aux: the MoE
    losses summed in layer order, float32), the caches stacked [R, ...] as
    the reference's scan stacks them.

    Under ``remat``, while autograd records (grad enabled and a block
    parameter or ``x`` requiring grad), each repeat runs inside
    ``torch.utils.checkpoint`` as the reference's scan body runs inside
    ``jax.checkpoint``: its activations are recomputed in the backward,
    all of them under ``perf`` ``remat_policy="block"``, all but its 2-D
    matrix products' outputs under ``"dots"`` (:func:`_dots_saveable`).
    The recompute runs under the profile the forward ran under, whichever
    thread autograd runs it on (the profile is thread-local, and a CUDA
    backward runs on autograd's device thread)."""
    pattern = ("attn",) if encoder else cfg.layer_pattern
    keep = caches is not None or collect_cache
    env = get_env()
    gathers = None
    if env.is_live:     # each layer's full shapes and specs, repeat axis off
        cross = cfg.family == "encdec" and not encoder
        gathers = {f"l{i}": (
            _unstack(_layer_shapes(cfg, kind, i, cross=cross,
                                   encoder=encoder)),
            _unstack(_layer_specs(cfg, kind, i, cross=cross,
                                  encoder=encoder)))
            for i, kind in enumerate(pattern)}

    def layer_params(name, r):
        p = _index(blocks[name], r)
        return p if gathers is None else gather_fsdp(p, *gathers[name])

    def repeat(r, x):
        new, auxes = [], []
        for i, kind in enumerate(pattern):
            name = f"l{i}"
            c = None if caches is None else tuple(t[r] for t in caches[name])
            ck = (None if cross_kvs is None
                  else tuple(t[r] for t in cross_kvs[name]))
            x, nc, a = _apply_layer(cfg, kind, i, layer_params(name, r), x,
                                    positions=positions, cache=c,
                                    cache_len=cache_len, memory=memory,
                                    cross_kv=ck, causal=causal,
                                    encoder=encoder)
            new.append(nc)
            if a is not None:
                auxes.append(a)
        return x, new, auxes

    if remat and torch.is_grad_enabled() and (x.requires_grad or any(
            t.requires_grad for t in _leaves(blocks))):
        policy = get_perf().remat_policy
        if policy not in ("block", "dots"):
            raise ValueError(f"remat_policy {policy!r}: expected 'block' "
                             "or 'dots'")
        context = {} if policy == "block" else {
            "context_fn": functools.partial(
                create_selective_checkpoint_contexts, _dots_saveable)}
        perf = get_perf()

        def pinned(r, x):
            # the recompute runs in the backward, on the CUDA device's
            # autograd thread, whose profile and mesh env are its own: pin
            # the forward's
            prev, prev_env = get_perf(), get_env()
            set_perf(perf)
            set_env(env)
            try:
                return repeat(r, x)
            finally:
                set_perf(prev)
                set_env(prev_env)

        def run(r, x):
            return checkpoint(pinned, r, x, use_reentrant=False, **context)
    else:
        run = repeat

    per_layer: dict[str, list] = {f"l{i}": [] for i in range(len(pattern))}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for r in range(_repeats(blocks)):
        x, new, auxes = run(r, x)
        for a in auxes:     # in layer order, as the reference sums them
            aux = aux + a
        if keep:
            for i, nc in enumerate(new):
                per_layer[f"l{i}"].append(nc)
    if not keep:
        return x, None, aux
    return x, {name: tuple(torch.stack(parts) for parts in zip(*layer))
               for name, layer in per_layer.items()}, aux


def _dots_saveable(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat_policy="dots"``, the
    counterpart of JAX's ``dots_with_no_batch_dims_saveable``: keep the
    outputs of 2-D matrix products (``mm``, ``addmm``, and ``bmm`` over a
    batch of one, which is how ``torch.einsum`` runs a product with no
    batch dimension), recompute everything else."""
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (
            op == aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _repeats(tree) -> int:
    """The leading (repeat) axis of a stacked parameter tree."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def _index(tree, r: int):
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


def _unstack(tree):
    """A stacked shape or spec tree without its leading repeat entry."""
    if isinstance(tree, dict):
        return {k: _unstack(v) for k, v in tree.items()}
    return tuple(tree[1:])


def gather_fsdp(tree, shapes, specs):
    """Each leaf of ``tree`` (this rank's shards) with its fsdp dimension
    all-gathered to its full length in ``shapes`` (``gather_shard``: the
    gradient reduce-scatters back); leaves not split over fsdp as they
    are. ``specs`` are the leaves' logical specs."""
    env = get_env()
    if isinstance(tree, dict):
        return {k: gather_fsdp(v, shapes[k], specs[k])
                for k, v in tree.items()}
    for dim, axes in enumerate(logical_spec(*specs, env=env)):
        if env.fsdp in axes:
            if axes != (env.fsdp,):
                raise ValueError(f"spec {specs}: fsdp shares a dimension")
            return C.gather_shard(tree, dim, shapes[dim],
                                  env.group(env.fsdp))
    return tree


def _tables(cfg: ModelConfig, params: dict) -> tuple:
    """(embedding table, output head) as a forward uses them: on a live
    mesh this rank's vocabulary rows with the model dimension gathered
    over fsdp, gathered once when the two are tied."""
    head = params.get("lm_head", params["embed"])
    if not get_env().is_live:
        return params["embed"], head
    shape = (vocab_pad(cfg), cfg.d_model)
    emb = gather_fsdp(params["embed"], shape, ("tp", "fsdp"))
    if "lm_head" not in params:
        return emb, emb
    return emb, gather_fsdp(params["lm_head"], shape, ("tp", "fsdp"))


def _logits(cfg: ModelConfig, params: dict, x: torch.Tensor,
            head: torch.Tensor) -> torch.Tensor:
    """The output logits [.., V_pad] through ``head`` (``_tables``); on a
    live mesh this rank's vocabulary columns."""
    x = L.rms_norm(x, params["final_norm"], cfg.rms_eps)
    xc = x.to(L.COMPUTE_DTYPE)
    tp = L.tp_region()
    if tp is not None:
        xc = C.copy_to_tp(xc, tp[0])
    return xc @ head.to(L.COMPUTE_DTYPE).T


def _embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings from ``table`` (``_tables``) in the compute dtype;
    on a live mesh a masked lookup of this rank's vocabulary rows,
    all-reduced over tp."""
    tp = L.tp_region()
    if tp is None:
        # index, then cast: the same bits as casting the table first
        return table[tokens].to(L.COMPUTE_DTYPE)
    v_loc = table.shape[0]
    local = tokens.long() - tp[1] * v_loc
    hit = (local >= 0) & (local < v_loc)
    rows = table[local.clamp(0, v_loc - 1)] * hit[..., None]
    return C.reduce_from_tp(rows.to(L.COMPUTE_DTYPE), tp[0])


def gather_vocab(logits: torch.Tensor) -> torch.Tensor:
    """The full vocabulary's logits from every tp rank's columns (a
    collective on a live mesh; ``logits`` itself off one)."""
    tp = L.tp_region()
    if tp is None:
        return logits
    return C.all_gather(logits.contiguous(), logits.ndim - 1, tp[0])


def _encode(cfg: ModelConfig, params: dict, enc_frames: torch.Tensor
            ) -> torch.Tensor:
    """The encoder over the stub frame embeddings [B, S_enc, D]: its
    ``n_enc_layers`` layers non-causally, with RoPE at positions
    ``arange(S_enc)``, then ``enc_final_norm``. Returns the memory the
    decoder cross-attends to, in ``enc_frames``' dtype."""
    _require_ported(cfg)
    positions = torch.arange(enc_frames.shape[1], device=enc_frames.device)
    x, _, _ = _run_blocks(cfg, params["enc_blocks"], enc_frames,
                          positions=positions, causal=False, encoder=True)
    return L.rms_norm(x, params["enc_final_norm"], cfg.rms_eps)


def forward_lm(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
               img_embeds: torch.Tensor | None = None,
               enc_frames: torch.Tensor | None = None,
               memory: torch.Tensor | None = None,
               collect_cache: bool = False, remat: bool = True):
    """Full-sequence forward (train / prefill). tokens [B, S_text] int; vlm:
    ``img_embeds`` [B, N_img, D] prepended (cast to the compute dtype),
    so the sequence and its positions span N_img + S_text; encdec:
    ``enc_frames`` [B, S_enc, D] through the encoder as the cross memory,
    or that memory itself (``_encode``'s output) as ``memory``.
    Returns (logits [B, S, V_pad] bf16, aux (the MoE load-balance losses
    summed over layers; 0.0 without MoE), caches if ``collect_cache`` else
    None). ``remat`` (the reference's default) checkpoints each decoder
    block repeat while autograd records, never the encoder (see
    ``_run_blocks``); without autograd it changes nothing."""
    _require_ported(cfg)
    table, head = _tables(cfg, params)
    x = _embed(table, tokens)
    if img_embeds is not None:
        x = torch.cat([img_embeds.to(x.dtype), x], dim=1)
    if enc_frames is not None:
        if memory is not None:
            raise ValueError("pass enc_frames or memory, not both")
        memory = _encode(cfg, params, enc_frames)
    positions = torch.arange(x.shape[1], device=x.device)
    x, caches, aux = _run_blocks(cfg, params["blocks"], x,
                                 positions=positions, memory=memory,
                                 collect_cache=collect_cache, remat=remat)
    return _logits(cfg, params, x, head), aux, caches


def cross_kvs_from_memory(cfg: ModelConfig, params: dict,
                          memory: torch.Tensor):
    """Every decoder layer's cross-attention k and v from the encoder's
    output [B, S_enc, D], bf16 [R, B, S_enc, KV, dh] each (with the
    biases where ``qkv_bias``), for ``decode_step(cross_kvs=)``."""
    mc = memory.to(L.COMPUTE_DTYPE)
    tp = L.tp_region()
    out = {}
    for name, bp in params["blocks"].items():
        p = bp["cross"]
        if get_env().is_live:
            p = gather_fsdp(p, _layer_shapes(cfg, "attn", 0,
                                             cross=True)["cross"],
                            _layer_specs(cfg, "attn", 0, cross=True)["cross"])
        if tp is not None:   # the kv heads this rank's q heads read
            p = L._kv_params(cfg, p, tp)
        k = torch.einsum("bsd,rdhk->rbshk", mc, p["wk"].to(L.COMPUTE_DTYPE))
        v = torch.einsum("bsd,rdhk->rbshk", mc, p["wv"].to(L.COMPUTE_DTYPE))
        if cfg.qkv_bias:
            k = k + p["bk"].to(L.COMPUTE_DTYPE)[:, None, None]
            v = v + p["bv"].to(L.COMPUTE_DTYPE)[:, None, None]
        out[name] = (k, v)
    return out


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor, caches,
                cache_len: int, cross_kvs=None):
    """One decode step. token [B, 1] int; ``cache_len`` is the current
    prefix length (where attention writes this step's k/v and the token's
    position; the SSM state does not read it; vlm: it counts the image
    tokens too); encdec: ``cross_kvs`` from ``cross_kvs_from_memory``.
    Returns (logits [B, 1, V_pad], new caches); ``caches`` is left as it
    was."""
    _require_ported(cfg)
    table, head = _tables(cfg, params)
    x = _embed(table, token)
    positions = torch.full((1,), int(cache_len), dtype=torch.int32,
                           device=x.device)
    x, new_caches, _ = _run_blocks(cfg, params["blocks"], x,
                                   positions=positions, caches=caches,
                                   cache_len=int(cache_len),
                                   cross_kvs=cross_kvs)
    return _logits(cfg, params, x, head), new_caches


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def cache_struct(cfg: ModelConfig, batch: int, s_max: int):
    """{"l{i}": ((shape, dtype, seq_axis), ...)} of the decode caches: for
    each tensor also the axis of its sequence (None if it has none), so
    that a server grows by kind, never by matching shapes. Attention:
    (k, v) [R, B, S, KV, dh] bf16; MLA: (c_kv [R, B, S, kv_lora], k_rope
    [R, B, S, dr]) bf16; both with the sequence on axis 2. SSM state has
    no sequence axis: (conv [R, B, K-1, Di] bf16, h [R, B, Di, N] f32).
    KV heads are padded to the active tp."""
    _require_ported(cfg)
    r = cfg.block_repeats
    out = {}
    for i, kind in enumerate(cfg.layer_pattern):
        if kind == "ssm":
            s_cfg, d_in, _ = S.ssm_dims(cfg)
            out[f"l{i}"] = (
                ((r, batch, s_cfg.d_conv - 1, d_in), torch.bfloat16, None),
                ((r, batch, d_in, s_cfg.d_state), torch.float32, None))
        elif cfg.mla is not None:
            m = cfg.mla
            out[f"l{i}"] = (
                ((r, batch, s_max, m.kv_lora), torch.bfloat16, 2),
                ((r, batch, s_max, m.rope_head_dim), torch.bfloat16, 2))
        else:
            _, kv = L.pad_heads(cfg.n_heads, cfg.n_kv, get_env().tp_size())
            shape = (r, batch, s_max, kv, cfg.head_dim)
            out[f"l{i}"] = ((shape, torch.bfloat16, 2),
                            (shape, torch.bfloat16, 2))
    return out


def cross_kv_struct(cfg: ModelConfig, batch: int):
    """{"l{i}": ((shape, dtype, seq_axis), (shape, dtype, seq_axis))} of
    the encdec decode's cross k/v: [R, B, enc_seq, KV, dh] bf16 each, in
    ``cache_struct``'s convention; ``seq_axis`` is None, because their
    length is the encoder's, fixed, and a server never grows them."""
    _require_ported(cfg)
    _, kv = L.pad_heads(cfg.n_heads, cfg.n_kv, get_env().tp_size())
    shape = (cfg.block_repeats, batch, cfg.enc_seq, kv, cfg.head_dim)
    return {f"l{i}": ((shape, torch.bfloat16, None),
                      (shape, torch.bfloat16, None))
            for i in range(len(cfg.layer_pattern))}


def _batch_split(batch: int) -> bool:
    """Whether a batch of ``batch`` sequences splits over the active dp."""
    dp = get_env().dp_size()
    return batch % dp == 0 and batch >= dp and dp > 1


def cache_specs(cfg: ModelConfig, batch: int):
    """The logical partition specs of ``cache_struct``'s tensors, in its
    layout (the reference's policy): the batch over dp when it splits
    evenly, the attention and MLA sequence over tp; a batch below dp
    (long-context decode) splits the sequence over (dp, tp). SSM state
    splits its channels over tp, and its batch only when that splits."""
    _require_ported(cfg)
    split = _batch_split(batch)
    if split:
        b_spec, s_spec = "dp", "tp"
    elif get_env().dp_size() > 1:
        b_spec, s_spec = None, ("dp", "tp")
    else:
        b_spec, s_spec = None, "tp"
    out = {}
    for i, kind in enumerate(cfg.layer_pattern):
        if kind == "ssm":
            out[f"l{i}"] = ((None, b_spec if split else None, None, "tp"),
                            (None, b_spec if split else None, "tp", None))
        elif cfg.mla is not None:
            out[f"l{i}"] = ((None, b_spec, s_spec, None),) * 2
        else:
            out[f"l{i}"] = ((None, b_spec, s_spec, None, None),) * 2
    return out


def cross_kv_specs(cfg: ModelConfig, batch: int):
    """The logical partition specs of ``cross_kv_struct``'s tensors: the
    batch over dp when it splits evenly, nothing else split."""
    _require_ported(cfg)
    b_spec = "dp" if _batch_split(batch) else None
    return {f"l{i}": ((None, b_spec, None, None, None),) * 2
            for i in range(len(cfg.layer_pattern))}

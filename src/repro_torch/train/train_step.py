"""Train step: the causal-LM loss (with the MoE auxiliary loss), gradients
and one AdamW update (the counterpart of ``repro/train/train_step.py``).

The loss masks the padded vocabulary's logits and ignores labels of -100;
``microbatches`` accumulates float32 gradients over slices of the batch.
Gradients come from ``torch.autograd.grad`` over the parameter tree's
leaves; the parameters passed in are never modified.

On a live mesh (``sharding.env``) every function takes the *global* batch,
as the reference's jitted step does, and each rank keeps its dp rows
(``data.pipeline.dp_rows``); parameters, gradients and moments are this
rank's shards. The loss is the global mean: the token count is summed over
dp, and the logits' vocabulary is split over tp, so the cross-entropy's
max, sum of exponentials and target logit are each combined over tp.
Gradients of leaves not split over fsdp are summed over dp (fsdp leaves'
already were, by the reduce-scatter of their gather), and those a
tensor-parallel region uses whole on every tp rank over tp too. The MoE
auxiliary loss is computed by each dp block over its own tokens, as the
reference's ``shard_map`` computes it; as there, the gradient is the mean
of the blocks' and the value reported (``aux``, ``total``) block 0's.
"""
from __future__ import annotations

from functools import partial

import torch

from ..configs.base import ModelConfig
from ..core import collectives as C
from ..data.pipeline import dp_rows
from ..models import layers as L
from ..models import lm
from ..sharding.env import get_env, logical_spec
from .optimizer import (AdamWConfig, OptState, apply_updates, tree_leaves,
                        tree_map)

AUX_WEIGHT = 0.01


def lm_loss(cfg: ModelConfig, params, batch: dict
            ) -> tuple[torch.Tensor, dict]:
    """batch: tokens [B, S], labels [B, S] (-100 = ignore), and the
    modality's extra: ``img_embeds`` (vlm; its positions carry no loss) or
    ``enc_frames`` (encdec). Returns (the objective to differentiate,
    {"loss", "aux", "ntok", "total"}), float32 scalars; "total" is loss +
    AUX_WEIGHT · aux, and so is the objective off a live mesh.

    The cross-entropy runs on this rank's vocabulary columns (all of them
    off a live mesh): their max, sum of exponentials and target logit are
    combined over tp. On a live mesh ``batch`` holds this rank's dp rows:
    the objective's gradients summed over dp are the global loss's, and
    the metrics are global."""
    kw = {}
    if cfg.family == "vlm":
        kw["img_embeds"] = batch["img_embeds"]
    if cfg.family == "encdec":
        kw["enc_frames"] = batch["enc_frames"]
    logits, aux, _ = lm.forward_lm(cfg, params, batch["tokens"], **kw)
    labels = batch["labels"]
    if cfg.family == "vlm":  # image positions carry no loss
        pad = torch.full((labels.shape[0], cfg.n_img_tokens), -100,
                         dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)

    env = get_env()
    tp = L.tp_region()
    lf = logits.float()
    v_loc = lf.shape[-1]
    v_lo = (tp[1] if tp is not None else 0) * v_loc
    col = v_lo + torch.arange(v_loc, device=lf.device)
    lf = torch.where(col < cfg.vocab, lf,
                     torch.full((), -1e30, device=lf.device))
    m = lf.detach().amax(dim=-1).contiguous()
    if tp is not None:
        C.all_reduce_(m, "max", tp[0])
    se = torch.exp(lf - m[..., None]).sum(dim=-1)
    lab = labels.clamp(min=0).long() - v_lo
    hit = (lab >= 0) & (lab < v_loc)
    gold = torch.where(hit, torch.take_along_dim(
        lf, lab.clamp(0, v_loc - 1)[..., None], dim=-1)[..., 0], 0.0)
    if tp is not None:
        se = C.reduce_from_tp(se, tp[0])
        gold = C.reduce_from_tp(gold, tp[0])
    logz = m + torch.log(se)
    tok_mask = (labels >= 0).float()
    nll = (logz - gold) * tok_mask
    ntok = torch.clamp(_dp_sum_(torch.sum(tok_mask).detach().clone(), env),
                       min=1.0)
    loss_loc = torch.sum(nll) / ntok
    dp = env.dp_size() if env.is_live else 1
    objective = loss_loc + AUX_WEIGHT * aux / dp
    loss = _dp_sum_(loss_loc.detach().clone(), env)
    # the reference's shard_map returns each dp block's aux under a
    # replicated out-spec: its value is block 0's, its gradient the mean's
    aux0 = _dp_sum_(aux.detach().float() * float(env.dp_index() == 0),
                    env)
    return objective, {"loss": loss, "aux": aux0, "ntok": ntok,
                       "total": loss + AUX_WEIGHT * aux0}


def _dp_sum_(t: torch.Tensor, env) -> torch.Tensor:
    """``t`` summed in place over the dp axes of a live env (as it is off
    one: a dry run's env names the axes but joins no ranks)."""
    if env.is_live:
        for a in env.dp:
            C.all_reduce_(t, "sum", env.group(a))
    return t


def _in_region(path: tuple) -> bool:
    return any(k in ("mixer", "cross", "ffn") for k in path)


def reduce_grads(cfg: ModelConfig, grads):
    """On a live mesh, each rank's gradients of its shards made whole:
    summed over dp where the leaf is not split over fsdp (over "pod" too
    where it is: its reduce-scatter ran over "data" only), and over tp
    where a tensor-parallel region (a mixer, cross-attention or FFN) uses
    the leaf whole on every tp rank, each rank's part of the gradient."""
    env = get_env()

    def walk(g, spec, path):
        if isinstance(g, dict):
            return {k: walk(g[k], spec[k], path + (k,)) for k in g}
        axes = {a for part in logical_spec(*spec, env=env) for a in part}
        g = g.contiguous()
        dp = [a for a in env.dp if a != env.fsdp] if env.fsdp in axes \
            else list(env.dp)
        for a in dp:
            C.all_reduce_(g, "sum", env.group(a))
        if env.tp is not None and env.tp not in axes and _in_region(path):
            C.all_reduce_(g, "sum", env.group(env.tp))
        return g

    return walk(grads, lm.param_specs(cfg), ())


def split_axes(cfg: ModelConfig):
    """The mesh axes each parameter is split over on the active env, a
    tree of sorted tuples (``optimizer.global_norm``'s ``split``)."""
    env = get_env()

    def walk(spec):
        if isinstance(spec, dict):
            return {k: walk(v) for k, v in spec.items()}
        return tuple(sorted({a for part in logical_spec(*spec, env=env)
                             for a in part}))
    return walk(lm.param_specs(cfg))


def value_and_grad(cfg: ModelConfig, params, batch: dict):
    """(total, metrics, grads): the gradient of ``lm_loss`` with respect to
    every parameter leaf, in the leaf's dtype (zero where a leaf does not
    reach the loss). On a live mesh ``batch`` is the global batch, and
    the gradients are this rank's shards of the global loss's
    (``reduce_grads``)."""
    env = get_env()
    if env.is_live:
        batch = dp_rows(batch)
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    objective, metrics = lm_loss(cfg, live, batch)
    leaves = tree_leaves(live)
    grads = torch.autograd.grad(objective, leaves, allow_unused=True)
    by_id = {id(p): g if g is not None else torch.zeros_like(p)
             for p, g in zip(leaves, grads)}
    grads = tree_map(lambda p: by_id[id(p)], live)
    total = metrics.pop("total")
    if env.is_live:
        grads = reduce_grads(cfg, grads)
    return (total.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, params,
               opt_state: OptState, batch: dict, *, microbatches: int = 1):
    """One optimizer step; with ``microbatches`` > 1 the batch is cut into
    that many slices along its first axis, their float32 gradients summed
    and divided, and their metrics averaged. Returns (new params, new
    OptState, metrics: loss, aux, ntok, grad_norm, lr and total)."""
    if microbatches <= 1:
        total, metrics, grads = value_and_grad(cfg, params, batch)
    else:
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        total, parts = 0.0, []
        for i in range(microbatches):
            mb = {k: v[i * v.shape[0] // microbatches:
                       (i + 1) * v.shape[0] // microbatches]
                  for k, v in batch.items()}
            t, m, g = value_and_grad(cfg, params, mb)
            grads = tree_map(torch.add, grads, g)
            total = total + t
            parts.append(m)
        grads = tree_map(lambda g: g / microbatches, grads)
        total = total / microbatches
        metrics = {k: torch.mean(torch.stack([m[k] for m in parts]))
                   for k in parts[0]}
    split = split_axes(cfg) if get_env().is_live else None
    new_params, new_opt, opt_metrics = apply_updates(
        opt_cfg, params, grads, opt_state, split=split)
    return new_params, new_opt, dict(metrics, **opt_metrics, total=total)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    microbatches: int = 1):
    """``train_step`` with the configurations bound: (params, opt_state,
    batch) -> (params, opt_state, metrics)."""
    return partial(train_step, cfg, opt_cfg, microbatches=microbatches)

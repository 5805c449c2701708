"""Train step: the causal-LM loss (with the MoE auxiliary loss), gradients
and one AdamW update (the counterpart of ``repro/train/train_step.py``).

The loss masks the padded vocabulary's logits and ignores labels of -100;
``microbatches`` accumulates float32 gradients over slices of the batch.
Gradients come from ``torch.autograd.grad`` over the parameter tree's
leaves; the parameters passed in are never modified.
"""
from __future__ import annotations

from functools import partial

import torch

from ..configs.base import ModelConfig
from ..models import lm
from .optimizer import (AdamWConfig, OptState, apply_updates, tree_leaves,
                        tree_map)

AUX_WEIGHT = 0.01


def lm_loss(cfg: ModelConfig, params, batch: dict
            ) -> tuple[torch.Tensor, dict]:
    """batch: tokens [B, S], labels [B, S] (-100 = ignore), and the
    modality's extra: ``img_embeds`` (vlm; its positions carry no loss) or
    ``enc_frames`` (encdec). Returns (loss + AUX_WEIGHT · aux, {"loss",
    "aux", "ntok"}), float32 scalars."""
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

    vp = logits.shape[-1]
    mask_v = torch.arange(vp, device=logits.device) < cfg.vocab
    logits = torch.where(mask_v[None, None, :], logits.float(),
                         torch.full((), -1e30, device=logits.device))
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(
        logits, labels.clamp(min=0).long()[..., None], dim=-1)[..., 0]
    tok_mask = (labels >= 0).float()
    nll = (logz - gold) * tok_mask
    ntok = torch.clamp(torch.sum(tok_mask), min=1.0)
    loss = torch.sum(nll) / ntok
    total = loss + AUX_WEIGHT * aux
    return total, {"loss": loss, "aux": aux, "ntok": ntok}


def value_and_grad(cfg: ModelConfig, params, batch: dict):
    """(total, metrics, grads): the gradient of ``lm_loss`` with respect to
    every parameter leaf, in the leaf's dtype (zero where a leaf does not
    reach the loss)."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    total, metrics = lm_loss(cfg, live, batch)
    leaves = tree_leaves(live)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    by_id = {id(p): g if g is not None else torch.zeros_like(p)
             for p, g in zip(leaves, grads)}
    return (total.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda p: by_id[id(p)], live))


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
    new_params, new_opt, opt_metrics = apply_updates(
        opt_cfg, params, grads, opt_state)
    return new_params, new_opt, dict(metrics, **opt_metrics, total=total)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    microbatches: int = 1):
    """``train_step`` with the configurations bound: (params, opt_state,
    batch) -> (params, opt_state, metrics)."""
    return partial(train_step, cfg, opt_cfg, microbatches=microbatches)

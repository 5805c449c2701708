"""Serving: prefill plus single-token decode steps, and a small batched
greedy engine (the counterpart of ``repro/serve/serve_step.py``), with the
encdec family's audio frames and the vlm family's image embeddings.

On a live mesh (``sharding.env``) the weights are this rank's shards, the
logits this rank's vocabulary columns (``greedy_token`` takes the argmax
over all of them) and the caches its own: ``Engine.generate`` takes the
global prompts, keeps this rank's dp rows when the batch divides over dp
(else every dp rank serves the whole batch, ``MeshEnv.batch_split``
False) and returns every sequence's tokens on every rank."""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core import collectives as C
from ..data.pipeline import dp_rows
from ..models import layers as L
from ..models import lm
from ..sharding.env import get_env, use_mesh


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, **modality):
    """Full-sequence forward collecting the decode caches; ``modality``:
    ``img_embeds`` (vlm), ``enc_frames`` or the encoder's ``memory``
    (encdec), as ``lm.forward_lm`` takes them. Returns (logits, caches)."""
    logits, _, caches = lm.forward_lm(cfg, params, tokens,
                                      collect_cache=True, **modality)
    return logits, caches


def decode(cfg: ModelConfig, params, token: torch.Tensor, caches,
           cache_len: int, cross_kvs=None):
    """One token for every sequence in the batch. token [B, 1]; encdec:
    ``cross_kvs`` from ``lm.cross_kvs_from_memory``."""
    return lm.decode_step(cfg, params, token, caches, cache_len,
                          cross_kvs=cross_kvs)


def greedy_token(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Argmax over the real vocabulary (padding columns masked to -inf),
    int32; ties go to the first index. On a live mesh ``logits`` are this
    rank's vocabulary columns: the largest value is taken over tp, and the
    lowest id holding it, as ``jnp.argmax`` over the whole row."""
    tp = L.tp_region()
    v_lo = 0 if tp is None else tp[1] * logits.shape[-1]
    col = v_lo + torch.arange(logits.shape[-1], device=logits.device)
    masked = torch.where(col < vocab, logits, float("-inf"))
    idx = torch.argmax(masked, dim=-1)
    if tp is None:
        return idx.to(torch.int32)
    val = torch.take_along_dim(masked, idx[..., None], dim=-1)[..., 0]
    best = C.all_reduce_(val.float().clone(), "max", tp[0])
    first = torch.where(val.float() == best, idx + v_lo,
                        torch.iinfo(torch.int64).max).contiguous()
    return C.all_reduce_(first, "min", tp[0]).to(torch.int32)


def grow_caches(cfg: ModelConfig, caches, batch: int, s_max: int):
    """Pad every cache tensor that has a sequence axis to ``s_max`` along
    it, chosen by kind from ``lm.cache_struct`` (the reference decides by
    matching shapes, which pads an SSM conv window whose length happens to
    equal the prompt's). SSM caches have no sequence axis and are kept."""
    struct = lm.cache_struct(cfg, batch, s_max)
    out = {}
    for name, tensors in caches.items():
        grown = []
        for t, (_, _, axis) in zip(tensors, struct[name]):
            if axis is not None:
                pad = [0, 0] * (t.ndim - axis - 1) + [0, s_max - t.shape[axis]]
                t = F.pad(t, pad)
            grown.append(t)
        out[name] = tuple(grown)
    return out


class Engine:
    """Minimal batched serving loop: prefill a batch of prompts, then
    greedy-decode step by step. ``s_max`` counts text positions: prompt
    and new tokens."""

    def __init__(self, cfg: ModelConfig, params, s_max: int):
        self.cfg, self.params, self.s_max = cfg, params, s_max

    @torch.inference_mode()
    def generate(self, tokens: torch.Tensor, n_new: int,
                 img_embeds: torch.Tensor | None = None,
                 enc_frames: torch.Tensor | None = None) -> torch.Tensor:
        """tokens [B, S0] int -> the ``n_new`` greedy tokens [B, n_new]
        int32 that follow each prompt.

        encdec: ``enc_frames`` [B, S_enc, D] go through the encoder once;
        its output is the prefill's cross memory and gives every decoder
        layer's cross k/v for the decode steps.
        vlm: ``img_embeds`` [B, N_img, D] are prepended to the prompts, so
        the caches grow to N_img + ``s_max`` and decode step i writes and
        attends at position N_img + S0 + i. Here the port departs from the
        reference's ``generate``, which decodes at S0 and leaves the
        caches N_img + S0 long: its first step then overwrites the cache
        entry of an image token and misses a prefill of one more token.

        On a live mesh every rank passes the same global inputs and gets
        every sequence's tokens back.
        """
        env = get_env()
        if not env.is_live:
            return self._generate(tokens, n_new, img_embeds, enc_frames)
        b, dp = tokens.shape[0], env.dp_size()
        split = b % dp == 0 and b >= dp
        rows = {"tokens": tokens}
        rows.update((k, v) for k, v in (("img_embeds", img_embeds),
                                        ("enc_frames", enc_frames))
                    if v is not None)
        if split:
            rows = dp_rows(rows, env)
        with use_mesh(dataclasses.replace(env, batch_split=split)):
            out = self._generate(rows["tokens"], n_new,
                                 rows.get("img_embeds"),
                                 rows.get("enc_frames"))
        if split:
            for a in reversed(env.dp):        # row-major: data, then pod
                out = C.all_gather(out, 0, env.group(a))
        return out

    def _generate(self, tokens, n_new, img_embeds, enc_frames):
        cfg = self.cfg
        b, s0 = tokens.shape
        if s0 + n_new > self.s_max:
            raise ValueError(f"prompt {s0} + {n_new} new tokens exceed "
                             f"s_max {self.s_max}")
        modality, cross_kvs, n_img = {}, None, 0
        if img_embeds is not None:
            modality["img_embeds"] = img_embeds
            n_img = img_embeds.shape[1]
        if enc_frames is not None:
            memory = lm._encode(cfg, self.params, enc_frames)
            modality["memory"] = memory
            cross_kvs = lm.cross_kvs_from_memory(cfg, self.params, memory)
        logits, caches = prefill(cfg, self.params, tokens, **modality)
        caches = grow_caches(cfg, caches, b, n_img + self.s_max)
        tok = greedy_token(logits[:, -1:, :], cfg.vocab)
        out = [tok]
        for n in range(n_img + s0, n_img + s0 + n_new - 1):
            logits, caches = decode(cfg, self.params, tok, caches, n,
                                    cross_kvs)
            tok = greedy_token(logits[:, -1:, :], cfg.vocab)
            out.append(tok)
        return torch.cat(out, dim=1)

"""Serving: prefill plus single-token decode steps, and a small batched
greedy engine (the counterpart of ``repro/serve/serve_step.py``), with the
encdec family's audio frames and the vlm family's image embeddings."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..models import lm


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
    int32; ties go to the first index."""
    col = torch.arange(logits.shape[-1], device=logits.device)
    masked = torch.where(col < vocab, logits, float("-inf"))
    return torch.argmax(masked, dim=-1).to(torch.int32)


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
        """
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

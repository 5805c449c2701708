"""Deterministic synthetic data pipeline (the counterpart of
``repro/data/pipeline.py``).

Tokenised LM batches, plus the stub modality inputs of the vlm and encdec
families, from a seeded numpy generator: ``batch_at(step)`` is pure, so
``(seed, step)`` is all a restart needs. The draws are the reference's,
in its order, so every batch is the reference's bit for bit: the tokens
and labels exactly, the image-patch and audio-frame embeddings
``0.02 · N(0, 1)`` in float32, rounded to bfloat16 (to nearest even, as
JAX rounds). On a live mesh each dp rank takes its rows of the global
batch (:func:`dp_rows`), the reference's batch sharding.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.graph import resolve_device
from ..sharding.env import get_env


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int
    seq_len: int
    seed: int = 0


class SyntheticPipeline:
    """Zipf-distributed token stream — cheap, deterministic, vocab-shaped.
    Tensors land on ``device`` (None: the card)."""

    def __init__(self, cfg: ModelConfig, data: DataConfig, device=None):
        self.cfg, self.data = cfg, data
        self.device = resolve_device(device)

    def batch_at(self, step: int) -> dict[str, torch.Tensor]:
        """{"tokens", "labels"} [B, S] int32, the labels the tokens shifted
        by one; vlm: "img_embeds" [B, n_img_tokens, D] bf16; encdec:
        "enc_frames" [B, enc_seq, D] bf16."""
        cfg, d = self.cfg, self.data
        rng = np.random.default_rng((d.seed << 20) ^ step)
        # zipf-ish: sample from a power-law over the vocab
        u = rng.random((d.batch, d.seq_len + 1))
        toks = np.minimum((cfg.vocab * u ** 3).astype(np.int64),
                          cfg.vocab - 1).astype(np.int32)
        batch = {"tokens": self._put(toks[:, :-1]),
                 "labels": self._put(toks[:, 1:])}
        if cfg.family == "vlm":
            batch["img_embeds"] = self._embeds(
                rng, (d.batch, cfg.n_img_tokens, cfg.d_model))
        if cfg.family == "encdec":
            batch["enc_frames"] = self._embeds(
                rng, (d.batch, cfg.enc_seq, cfg.d_model))
        return batch

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _embeds(self, rng, shape) -> torch.Tensor:
        x = rng.standard_normal(shape).astype(np.float32)
        return self._put(0.02 * x).to(torch.bfloat16)

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def dp_rows(batch: dict, env=None) -> dict:
    """This rank's rows of every tensor of the global ``batch`` on the
    active (or ``env``'s) mesh: the ``i``-th of dp equal blocks along the
    first axis, ``i`` this rank's dp index (pod-major). Raises unless the
    batch divides over dp."""
    env = get_env() if env is None else env
    n, i = env.dp_size(), env.dp_index()
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        if b % n:
            raise ValueError(f"dp_rows: a batch of {b} ({k}) does not "
                             f"split over dp = {n}")
        out[k] = v[i * (b // n):(i + 1) * (b // n)]
    return out

"""Fault-tolerant training loop (the counterpart of
``repro/train/trainer.py``):

* checkpoint and restart — resume from the latest checkpoint on
  construction, periodic asynchronous saves, atomic publish;
* deterministic data skip-ahead — the pipeline is pure in (seed, step);
* stragglers — a step slower than ``straggler_factor`` × the running
  median is logged and counted;
* step retry — a step that raises is retried up to ``max_retries`` times
  from the last good state (the inputs of a step are never modified).

A step's time is taken on the host clock after ``torch.cuda.synchronize``
on the card (the counterpart of ``block_until_ready``). Under a live mesh
(``sharding.env``) the state is this rank's shards, and checkpoints are
saved whole and restored re-sharded (``lm.placements``): the reference's
elastic re-shard.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import statistics
import tempfile
import time

import torch

from ..ckpt.checkpoint import CheckpointManager
from ..configs.base import ModelConfig
from ..core.graph import resolve_device
from ..data.pipeline import DataConfig, SyntheticPipeline
from ..models import lm
from ..sharding.env import get_env
from .optimizer import AdamWConfig, init_opt_state
from .train_step import train_step

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro-ckpt")
    ckpt_every: int = 50
    log_every: int = 10
    microbatches: int = 1
    straggler_factor: float = 2.0
    max_retries: int = 3


class Trainer:
    """Trains ``cfg`` on ``SyntheticPipeline(cfg, data_cfg)`` on ``device``
    (None: the card): parameters from ``params``, else ``lm.init_params``
    with a generator seeded 0; resumed from ``tcfg.ckpt_dir``'s latest
    checkpoint when there is one."""

    def __init__(self, cfg: ModelConfig, opt_cfg: AdamWConfig,
                 data_cfg: DataConfig, tcfg: TrainerConfig, params=None,
                 device=None):
        self.cfg, self.opt_cfg, self.tcfg = cfg, opt_cfg, tcfg
        self.device = resolve_device(device)
        self.pipeline = SyntheticPipeline(cfg, data_cfg, self.device)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            params = lm.init_params(cfg, gen, self.device)
        self.params = params
        self.opt_state = init_opt_state(params)
        self.shardings = (lm.state_placements(cfg) if get_env().is_live
                          else None)
        self.step = 0
        latest = self.ckpt.latest_step()
        if latest is not None:
            state = self.ckpt.restore(
                {"params": self.params, "opt": self.opt_state},
                device=self.device, shardings=self.shardings)
            self.params, self.opt_state = state["params"], state["opt"]
            self.step = latest
            log.info("resumed from step %d", latest)

    def _save(self, blocking: bool = False) -> None:
        kw = {} if self.shardings is None else {"shardings": self.shardings}
        self.ckpt.save(self.step, {"params": self.params,
                                   "opt": self.opt_state},
                       blocking=blocking, **kw)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self) -> dict:
        """Steps until ``tcfg.steps``, then a blocking save (unless the
        periodic save already wrote the last step). Returns
        {"final_metrics": the last step's metrics as floats, "stragglers",
        "median_step_s", "step_s": each step's seconds, "losses": each
        step's loss}."""
        times: list[float] = []
        losses: list[float] = []
        stragglers = 0
        metrics = {}
        while self.step < self.tcfg.steps:
            batch = self.pipeline.batch_at(self.step)
            self._sync()
            t0 = time.perf_counter()
            for attempt in range(self.tcfg.max_retries + 1):
                try:
                    self.params, self.opt_state, metrics = train_step(
                        self.cfg, self.opt_cfg, self.params, self.opt_state,
                        batch, microbatches=self.tcfg.microbatches)
                    self._sync()
                    break
                except Exception as e:  # pragma: no cover — transient path
                    if attempt == self.tcfg.max_retries:
                        raise
                    log.warning("step %d failed (%s); retry %d",
                                self.step, e, attempt + 1)
            dt = time.perf_counter() - t0
            times.append(dt)
            losses.append(float(metrics["loss"]))
            if len(times) > 16:
                med = statistics.median(times[-64:])
                if dt > self.tcfg.straggler_factor * med:
                    stragglers += 1
                    log.warning("straggler step %d: %.2fs vs median %.2fs",
                                self.step, dt, med)
            self.step += 1
            if self.step % self.tcfg.log_every == 0:
                log.info("step %d loss=%.4f", self.step, losses[-1])
            if self.step % self.tcfg.ckpt_every == 0:
                self._save()
        self.ckpt.wait()
        if self.ckpt.latest_step() != self.step:   # else written already
            self._save(blocking=True)
        return {"final_metrics": {k: float(v) for k, v in metrics.items()},
                "stragglers": stragglers,
                "median_step_s": statistics.median(times) if times else 0.0,
                "step_s": times, "losses": losses}

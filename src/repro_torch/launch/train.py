"""Training launcher: seeded random weights, the synthetic pipeline, AdamW,
a checkpoint at the end, resume from the latest one.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --smoke --device cpu --steps 10                # one device, CPU
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --mesh 2x1 --backend gloo --smoke --device cpu --steps 10
    PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \\
        --arch qwen3-0.6b --mesh 2x4 --perf --steps 20  # 8 cards, NCCL

Runs on the card unless ``--device cpu``. ``--mesh`` takes ``1x1``,
``DxM`` or ``PxDxM`` (data, model; pod, data, model), as the reference's
launcher does. A mesh of more than one device runs one process a device
under ``torchrun``, over ``--backend`` (default ``nccl``; ``gloo`` for
the CPU or several ranks on one card), each rank on
``cuda:{LOCAL_RANK % device_count}``: every rank draws the whole model
from the seeded generator and keeps its shard (``models/lm.py``), takes
its dp rows of each global batch, and the checkpoint holds full leaves,
so a run resumes at any mesh. Rank 0 prints. ``--perf`` trains under the
``TUNED`` profile (the FA-2 attention backward, the additive causal mask).
"""
from __future__ import annotations

import argparse
import contextlib
import logging
import os
import tempfile

import torch

from ..ckpt.checkpoint import CheckpointManager
from ..configs import get_config
from ..data.pipeline import DataConfig, SyntheticPipeline
from ..models import lm
from ..models.perf import TUNED, set_perf
from ..sharding.env import use_mesh
from ..train.optimizer import AdamWConfig, init_opt_state
from ..train.train_step import train_step
from .distributed import is_main, join, leave
from .mesh import parse_mesh


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--backend", default="nccl",
                    help="torch.distributed backend under torchrun")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro-launch-train"))
    ap.add_argument("--perf", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    if args.perf:
        set_perf(TUNED)
    cfg = get_config(args.arch, smoke=args.smoke)
    mesh = parse_mesh(args.mesh)
    dev, live = join(mesh, args.backend, args.device,
                     kernels=("selective_scan", "selective_scan_bwd"))
    say = print if is_main() else (lambda *a, **k: None)
    try:
        with use_mesh(mesh, live) if live else contextlib.nullcontext():
            _train(cfg, args, dev, live, say)
    finally:
        leave()


def _train(cfg, args, dev, live, say) -> None:
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    opt = init_opt_state(params)
    shardings = None if live is None else lm.state_placements(cfg)
    ocfg = AdamWConfig(warmup_steps=5, total_steps=args.steps)
    pipe = SyntheticPipeline(cfg, DataConfig(args.batch, args.seq), dev)
    ckpt = CheckpointManager(args.ckpt_dir)
    start = ckpt.latest_step() or 0
    if start:
        state = ckpt.restore({"params": params, "opt": opt}, device=dev,
                             shardings=shardings)
        params, opt = state["params"], state["opt"]
        say(f"resumed from step {start}")
    for step in range(start, args.steps):
        params, opt, m = train_step(cfg, ocfg, params, opt,
                                    pipe.batch_at(step))
        if (step + 1) % 5 == 0:
            say(f"step {step+1}: loss={float(m['loss']):.4f} "
                f"gnorm={float(m['grad_norm']):.3f}")
    ckpt.save(args.steps, {"params": params, "opt": opt}, blocking=True,
              shardings=shardings)
    say(f"done; checkpoint at {args.ckpt_dir}")


if __name__ == "__main__":
    main()

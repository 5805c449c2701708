"""Training launcher: seeded random weights, the synthetic pipeline, AdamW,
a checkpoint at the end, resume from the latest one.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --smoke --device cpu --steps 10

Runs on the card unless ``--device cpu``. ``--perf`` trains under the
``TUNED`` profile (the FA-2 attention backward, the additive causal
mask). One device: there is no ``--mesh``; the port's sharding
environment and dry run (``sharding/``, ``launch/{mesh,specs,dryrun}.py``)
count a sharded step, and sharded execution is not ported yet.
"""
from __future__ import annotations

import argparse
import logging
import os
import tempfile

import torch

from ..ckpt.checkpoint import CheckpointManager
from ..configs import get_config
from ..core.graph import resolve_device
from ..data.pipeline import DataConfig, SyntheticPipeline
from ..models import lm
from ..models.perf import TUNED, set_perf
from ..train.optimizer import AdamWConfig, init_opt_state
from ..train.train_step import train_step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
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
    dev = resolve_device(args.device)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    opt = init_opt_state(params)
    ocfg = AdamWConfig(warmup_steps=5, total_steps=args.steps)
    pipe = SyntheticPipeline(cfg, DataConfig(args.batch, args.seq), dev)
    ckpt = CheckpointManager(args.ckpt_dir)
    start = ckpt.latest_step() or 0
    if start:
        state = ckpt.restore({"params": params, "opt": opt}, device=dev)
        params, opt = state["params"], state["opt"]
        print(f"resumed from step {start}")
    for step in range(start, args.steps):
        params, opt, m = train_step(cfg, ocfg, params, opt,
                                    pipe.batch_at(step))
        if (step + 1) % 5 == 0:
            print(f"step {step+1}: loss={float(m['loss']):.4f} "
                  f"gnorm={float(m['grad_norm']):.3f}")
    ckpt.save(args.steps, {"params": params, "opt": opt}, blocking=True)
    print(f"done; checkpoint at {args.ckpt_dir}")


if __name__ == "__main__":
    main()

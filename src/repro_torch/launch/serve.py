"""Serving launcher: seeded random weights and prompts, the batched greedy
engine, one line per request.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \\
        --smoke --device cpu --batch 4 --prompt-len 16 --n-new 8
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \\
        --arch qwen2-moe-a2.7b --mesh 1x2 --backend gloo --smoke --device cpu

``--arch`` takes the ported configurations: falcon-mamba-7b (ssm),
jamba-v0.1-52b (hybrid), qwen3-0.6b, qwen2-1.5b, granite-3-2b, qwen3-4b
(dense), qwen2-moe-a2.7b and deepseek-v2-236b (moe, the latter with MLA),
whisper-small (encdec: the encoder gets zero bf16 frames [B, enc_seq, D],
as the JAX launcher feeds it) and llava-next-34b (vlm: text only, no image
embeddings, as the JAX launcher runs it); ``--smoke`` picks the reduced
config. Runs on the card unless
``--device cpu``. ``--perf`` serves under the ``TUNED`` profile, as the
JAX launcher does: its attention settings (``models/perf.py``) apply to
the forward; its serving settings (bfloat16 weights, replicated over data
parallelism below a footprint) are read by the dry run's input specs
(``launch/specs.py``), which price a sharded deployment. ``--mesh``
(``1x1``, ``DxM``, ``PxDxM``) and ``--backend`` run one process a mesh
device under ``torchrun``, as ``launch/train.py`` describes: each rank
keeps its shard of the weights, its dp rows of the prompts (when they
divide) and its caches; every rank gets every sequence's tokens, and rank
0 prints them.
"""
from __future__ import annotations

import argparse
import contextlib

import torch

from ..configs import get_config
from ..models import lm
from ..models.perf import TUNED, set_perf
from ..serve.serve_step import Engine
from ..sharding.env import use_mesh
from .distributed import is_main, join, leave
from .mesh import parse_mesh


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="falcon-mamba-7b",
                    help="a ported configuration id (see the docstring)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--backend", default="nccl",
                    help="torch.distributed backend under torchrun")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--n-new", type=int, default=8)
    ap.add_argument("--perf", action="store_true",
                    help="serve under the TUNED perf profile")
    args = ap.parse_args(argv)

    if args.perf:
        set_perf(TUNED)
    cfg = get_config(args.arch, smoke=args.smoke)
    mesh = parse_mesh(args.mesh)
    dev, live = join(mesh, args.backend, args.device,
                     kernels=("selective_scan",))
    try:
        with use_mesh(mesh, live) if live else contextlib.nullcontext():
            _serve(cfg, args, dev)
    finally:
        leave()


def _serve(cfg, args, dev) -> None:
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init_params(cfg, gen, dev)
    engine = Engine(cfg, params, s_max=args.prompt_len + args.n_new + 8)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    kw = {}
    if cfg.family == "encdec":
        kw["enc_frames"] = torch.zeros((args.batch, cfg.enc_seq, cfg.d_model),
                                       dtype=torch.bfloat16, device=dev)
    out = engine.generate(prompts, n_new=args.n_new, **kw)
    if is_main():
        for i in range(args.batch):
            print(f"req {i}: {out[i].tolist()}")


if __name__ == "__main__":
    main()

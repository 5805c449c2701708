"""Dry run: count every (arch × shape) cell's step on the production mesh
and record its memory and roofline, allocating nothing (the counterpart of
``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k [--multi-pod] [--perf] [--out experiments/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

The reference lowers and compiles each step with XLA for 512 host devices
and reads the compiled program. The port has no compiler: under
``sharding.use_mesh`` it builds the cell's ``meta`` stand-ins
(``launch/specs.py``), runs the step once on them under
``roofline.count.Counter`` (the train step, ``serve_step.prefill`` or
``serve_step.decode`` with encdec's cross k/v), and derives the record:

* ``memory_analysis``: ``argument_size_in_bytes``, the exact per-device
  shard bytes of every argument (parameters, optimizer state, batch, token,
  caches, cross k/v and the int32 decode position, which the port passes
  as a host int and the reference as a device scalar), by input under
  ``argument_bytes``; ``output_size_in_bytes``, the per-device bytes of the
  step's outputs under the specs the reference gives them (parameters and
  optimizer state as their inputs, logits ("dp", None, "tp"), caches by
  ``lm.cache_specs``, metrics replicated); ``temp_size_in_bytes``, the
  step's peak of live allocated bytes split evenly over the chips;
* ``roofline``: ``roofline.analysis.analyze`` of the count;
* ``count_s``: the host seconds the count took, in place of the
  reference's ``lower_s`` and ``compile_s``. There is no ``hlo_bytes``.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from ..configs import SHAPES, all_archs
from ..configs.base import ModelConfig, ShapeConfig
from ..models import lm
from ..models.perf import BASELINE, TUNED, get_perf, set_perf
from ..roofline import analysis as RA
from ..roofline.count import Counter
from ..serve import serve_step
from ..sharding.env import Mesh, use_mesh
from ..train.optimizer import AdamWConfig
from ..train.train_step import train_step
from . import mesh as M
from .specs import input_specs, leaves_with_specs, shard_bytes

#: Logits' logical spec (``repro/models/lm.py:220``).
LOGITS_SPEC = ("dp", None, "tp")


def mesh_name(mesh: Mesh) -> str:
    return "x".join(str(n) for n in mesh.axis_sizes)


def step_inputs(spec: dict) -> dict:
    """The step's inputs from ``input_specs``' (stand-ins, specs) pairs,
    by name: the stand-ins alone."""
    return {k: spec[k][0] for k in ("params", "opt", "batch", "token",
                                    "caches", "cross") if k in spec}


def run_step(cfg: ModelConfig, shape: ShapeConfig, inputs: dict,
             cache_len: int | None = None):
    """One step of ``shape.kind`` on ``inputs`` (``step_inputs``' names,
    stand-ins or real tensors on one device): the train step with a
    default ``AdamWConfig``, a prefill, or one decode step at
    ``cache_len`` (default: the caches' last position). Returns its
    outputs."""
    p = inputs["params"]
    if shape.kind == "train":
        return train_step(cfg, AdamWConfig(), p, inputs["opt"],
                          inputs["batch"])
    if shape.kind == "prefill":
        return serve_step.prefill(cfg, p, **inputs["batch"])
    n = shape.seq_len - 1 if cache_len is None else cache_len
    return serve_step.decode(cfg, p, inputs["token"], inputs["caches"], n,
                             cross_kvs=inputs.get("cross"))


def count_step(cfg: ModelConfig, shape: ShapeConfig, inputs: dict,
               device: str = "meta", cache_len: int | None = None):
    """(counter, outputs, seconds) of one ``run_step`` under a
    ``Counter(device)``; the tally is ``counter.counts``."""
    t0 = time.perf_counter()
    with Counter(device) as c:
        out = run_step(cfg, shape, inputs, cache_len)
    return c, out, time.perf_counter() - t0


def output_specs(cfg: ModelConfig, shape: ShapeConfig, spec: dict, out):
    """The logical spec tree of ``run_step``'s outputs ``out``."""
    if shape.kind == "train":
        _, _, metrics = out
        return (spec["params"][1], spec["opt"][1],
                {k: () for k in metrics})
    logits, caches = out
    return (LOGITS_SPEC, lm.cache_specs(cfg, shape.global_batch))


def argument_bytes(spec: dict, counter: Counter | None = None
                   ) -> dict[str, int]:
    """Per-device shard bytes of each of the cell's arguments. With the
    ``counter`` that counted the step, only of the tensors it read, as
    ``jax.jit`` keeps only the arguments its step reads; the decode
    position (a host int in the port) counts where a layer reads it, an
    attention or MLA layer."""
    out = {}
    for k in ("params", "opt", "batch", "token", "caches", "cross"):
        if k in spec:
            structs, specs = spec[k]
            out[k] = shard_bytes(*_read_leaves(structs, specs, counter))
    if "cache_len" in spec:
        cfg = spec["cfg"]
        if "attn" in cfg.layer_pattern or cfg.mla is not None:
            out["cache_len"] = shard_bytes(*spec["cache_len"])
    return out


def _read_leaves(structs, specs, counter):
    pairs = [(t, s) for t, s in leaves_with_specs(structs, specs)
             if counter is None or counter.reads(t)]
    return [t for t, _ in pairs], [s for _, s in pairs]


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             perf: bool = False, *, cfg: ModelConfig | None = None,
             shape: ShapeConfig | None = None, mesh: Mesh | None = None
             ) -> dict:
    """Count one cell under BASELINE (or TUNED with ``perf``; the thread's
    profile is restored after) on the production mesh (or ``mesh``) and
    return its record. ``cfg`` and ``shape`` replace the registry's config
    and ``SHAPES[shape_name]``."""
    prev = get_perf()
    set_perf(TUNED if perf else BASELINE)
    try:
        return _run_cell(arch, shape_name, multi_pod, perf, cfg, shape, mesh)
    finally:
        set_perf(prev)


def _run_cell(arch, shape_name, multi_pod, perf, cfg, shape, mesh) -> dict:
    mesh = M.make_production_mesh(multi_pod=multi_pod) if mesh is None \
        else mesh
    rec = {"arch": arch, "shape": shape_name, "perf": perf,
           "mesh": mesh_name(mesh), "chips": mesh.size}
    with use_mesh(mesh):
        spec = input_specs(arch, shape_name, cfg=cfg, shape=shape)
        cfg, shape = spec["cfg"], spec["shape"]
        rec["params"] = cfg.param_count()
        rec["active_params"] = cfg.active_param_count()
        if spec["skip"]:
            rec["status"] = "skipped"
            rec["reason"] = spec["skip"]
            return rec
        counter, out, secs = count_step(cfg, shape, step_inputs(spec))
        counts = counter.counts
        args = argument_bytes(spec, counter)
        outputs = shard_bytes(out, output_specs(cfg, shape, spec, out))
        rec["count_s"] = round(secs, 1)
        rec["argument_bytes"] = args
        rec["memory_analysis"] = {
            "argument_size_in_bytes": sum(args.values()),
            "output_size_in_bytes": outputs,
            "temp_size_in_bytes": -(-counts.peak_live_bytes // mesh.size)}
        roof = RA.analyze(counts, cfg, shape, mesh, spec["params"])
        rec["roofline"] = roof.to_json()
        rec["status"] = "ok"
        print(f"[dryrun] {arch} x {shape_name} x {rec['mesh']}: "
              f"count {rec['count_s']}s, dominant={roof.dominant}, "
              f"compute={roof.compute_s:.4f}s mem={roof.memory_s:.4f}s "
              f"coll={roof.collective_s:.4f}s useful={roof.useful_ratio:.2f}",
              flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--perf", action="store_true",
                    help="use the TUNED perf profile")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = all_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]

    for arch, shape, mp in cells:
        tag = f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}"
        out_path = os.path.join(args.out, tag + ".json")
        if os.path.exists(out_path):
            with open(out_path) as f:
                if json.load(f).get("status") in ("ok", "skipped"):
                    print(f"[dryrun] {tag}: cached, skipping", flush=True)
                    continue
        try:
            rec = run_cell(arch, shape, mp, perf=args.perf)
        except Exception as e:
            rec = {"arch": arch, "shape": shape,
                   "mesh": "2x16x16" if mp else "16x16",
                   "status": "error", "error": str(e),
                   "traceback": traceback.format_exc()}
            print(f"[dryrun] {tag}: ERROR {e}", flush=True)
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()

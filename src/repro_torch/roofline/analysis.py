"""Roofline terms of a counted dry-run step (the counterpart of
``repro/roofline/analysis.py``).

Three terms per (arch × shape × mesh), each a time on one chip:

    compute    = FLOPs / chips / bf16 peak            (launch/mesh.py)
    memory     = bytes / chips / HBM bytes/s
    collective = collective bytes per chip / NVLink bytes/s (one way)

FLOPs and bytes are :mod:`roofline.count`'s tally of the whole step, run
once on ``meta`` stand-ins of the global shapes. Dividing by the chips
assumes the step's work splits evenly over them; an XLA count does not
assume that, it reads the per-device program, so a term here is what a
perfect split would give, and replicated work (a replicated norm, the
router) is charged once rather than on every chip.

The port has no compiler to insert collectives, so their bytes come from
the spec trees and the mesh (:func:`collective_bytes`), by this rule, in
the reference's byte conventions (all-gather: its output; all-reduce: 2 ×
its operand; reduce-scatter: its operand), per chip:

* every parameter split over fsdp is all-gathered at each use: once in a
  prefill or a decode step, twice in a training step (the forward, and the
  backward's recompute of the block);
* in a training step every gradient is reduced over the batch: an
  fsdp-split one reduce-scattered over fsdp (then all-reduced over the
  pods of a multi-pod mesh, whose replicas of it differ), any other one
  all-reduced over dp;
* with tp > 1, each layer all-reduces its activations [B/dp, S, D] in
  bfloat16 over tp after its mixer, after its cross-attention and after
  its FFN (where it has them), in every pass: one pass serving, three
  training (forward, recompute, backward); an encoder's layers too.

``MODEL_FLOPS`` (6·N·D analytic) is the useful-compute yardstick, as in
the reference; ``useful_ratio`` is MODEL_FLOPS per chip over counted
FLOPs per chip.
"""
from __future__ import annotations

import dataclasses

from ..launch import mesh as M
from ..launch.specs import leaves_with_specs
from ..sharding.env import env_from_mesh, logical_spec, shard_shape


@dataclasses.dataclass
class Roofline:
    flops: float                 # per device: the counted FLOPs / chips
    bytes_hbm: float             # per device: the counted bytes / chips
    coll_bytes: float            # per device, by the rule above
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_global: float    # 6·N·D (or analytic serve flops)
    useful_ratio: float          # model_flops_per_dev / flops
    raw_cost_analysis: dict      # the counter's global tally

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def model_flops(cfg, shape) -> float:
    """Analytic useful FLOPs for the whole step (all chips)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n_active * tokens
    # decode: one token per sequence + attention over the cache
    tokens = shape.global_batch
    flops = 2.0 * n_active * tokens
    # attention reads over cache: 2·2·S·(kv heads·dh)·layers per sequence
    kv_bytes_flops = 0.0
    for li in range(cfg.n_layers):
        kind = cfg.layer_pattern[li % len(cfg.layer_pattern)]
        if kind == "ssm":
            continue
        if cfg.mla is not None:
            width = cfg.mla.kv_lora
            heads = cfg.n_heads
            kv_bytes_flops += 2 * 2 * shape.seq_len * width * heads
        else:
            kv_bytes_flops += (2 * 2 * shape.seq_len
                               * cfg.n_kv * cfg.head_dim
                               * (cfg.n_heads // cfg.n_kv))
    return flops + kv_bytes_flops * tokens


def _elems(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def collective_bytes(cfg, shape, mesh, params) -> dict[str, float]:
    """Per-chip collective bytes of one step by kind ("all-gather",
    "reduce-scatter", "all-reduce"), by the module's rule. ``params`` is
    the cell's (stand-ins, specs) pair from ``launch.specs.input_specs``,
    taken as the step sees them (the serving knobs applied)."""
    env = env_from_mesh(mesh)
    out = {"all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 0.0}
    if not env.active or mesh.size == 1:
        return out
    train = shape.kind == "train"
    multi_pod = "pod" in env.dp
    for t, spec in leaves_with_specs(*params):
        shard = _elems(shard_shape(t.shape, spec, env)) * t.element_size()
        axes = {a for part in logical_spec(*spec, env=env) for a in part}
        fsdp = env.fsdp_size() if env.fsdp in axes else 1
        if fsdp > 1:
            out["all-gather"] += (2 if train else 1) * shard * fsdp
        if not train:
            continue
        if fsdp > 1:
            out["reduce-scatter"] += shard * fsdp
            if multi_pod:
                out["all-reduce"] += 2 * shard
        elif env.dp_size() > 1:
            out["all-reduce"] += 2 * shard
    if env.tp_size() > 1:
        b = shape.global_batch
        dp = env.dp_size()
        b_loc = b // dp if b >= dp and b % dp == 0 else b
        s = 1 if shape.kind == "decode" else shape.seq_len
        per_layer = 0
        for li in range(cfg.n_layers):
            per_layer += 1 + (cfg.family == "encdec")
            per_layer += cfg.ffn_kind(li % len(cfg.layer_pattern)) != "none"
        act = 2 * b_loc * s * cfg.d_model          # bfloat16
        n = per_layer * act
        if cfg.family == "encdec" and shape.kind != "decode":
            n += 2 * cfg.n_enc_layers * 2 * b_loc * cfg.enc_seq * cfg.d_model
        out["all-reduce"] += 2 * n * (3 if train else 1)
    return out


def analyze(counts, cfg, shape, mesh, params) -> Roofline:
    """The roofline of a step counted by ``roofline.count.Counter``
    (``counts``) on ``mesh``; ``params`` (stand-ins, specs) prices the
    collectives."""
    chips = mesh.size
    flops = counts.flops / chips
    hbm = counts.bytes / chips
    breakdown = collective_bytes(cfg, shape, mesh, params)
    coll = sum(breakdown.values())
    compute_s = flops / M.PEAK_FLOPS_BF16
    memory_s = hbm / M.HBM_BW
    coll_s = coll / M.LINK_BW
    dom = max(("compute", compute_s), ("memory", memory_s),
              ("collective", coll_s), key=lambda kv: kv[1])[0]
    mf = model_flops(cfg, shape)
    useful = (mf / chips) / flops if flops else 0.0
    raw = {"flops": counts.flops, "bytes": counts.bytes,
           "peak_live_bytes": counts.peak_live_bytes, "ops": counts.ops,
           "kernels": counts.kernels, "coll_breakdown": breakdown}
    return Roofline(flops=flops, bytes_hbm=hbm, coll_bytes=coll,
                    compute_s=compute_s, memory_s=memory_s,
                    collective_s=coll_s, dominant=dom,
                    model_flops_global=mf, useful_ratio=useful,
                    raw_cost_analysis=raw)

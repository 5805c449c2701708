"""Performance profile: the reference's tuning knobs (the counterpart of
``repro/models/perf.py``), field for field, thread-local as there.

``BASELINE`` is the reference's first configuration; ``TUNED`` holds the
settings it accepted. What the port reads:

* ``flash_custom_vjp`` — ``layers.flash_attention`` goes to
  ``flash_vjp.flash_fa2`` (the FA-2 backward, which recomputes each
  block's probabilities from the saved log-sum-exp) when ``q_offset`` is 0;
* ``additive_mask`` — the flash scan's causal mask as an additive -inf
  bias instead of a select (the same result);
* ``pv_bf16`` — the flash scan's PV product on bfloat16 probabilities and
  values, accumulated in float32;
* ``remat_policy`` — ``lm.forward_lm(remat=True)``: ``"block"``
  recomputes a whole block repeat in the backward, ``"dots"`` keeps its
  2-D matrix products' outputs and recomputes the rest;
* ``ssm_bf16`` — ``ssm.ssm_block`` raises when it is set: the selective
  scan kernel runs in float32 only.

``ssm_chunk`` has no counterpart: the reference's chunk is the length of
its associative scan, while the port's kernel carries the state over the
whole sequence in one launch (the backward's chunk of saved states is the
kernel's own, ``kernels.ops.SCAN_CHUNK``). ``serve_bf16`` and
``serve_replicate_dp_below_gb`` are read by the dry run's input specs
(``launch/specs.py``), as the reference's are: a serving cell's
parameters in bfloat16, and not split over fsdp where the batch cannot
split over dp and the tp-split weights fit. ``sp_activations`` is read by
nothing in either package's step (its constraints are sharding hints the
port does not apply).
"""
from __future__ import annotations

import dataclasses
import threading


@dataclasses.dataclass(frozen=True)
class PerfConfig:
    # flash attention: keep probs in bf16 for the PV matmul (f32 accum)
    pv_bf16: bool = False
    # flash attention: additive causal bias instead of a select
    additive_mask: bool = False
    # flash attention: FA2-style custom VJP (recompute probs in bwd)
    flash_custom_vjp: bool = False
    # remat: "block" = full-block checkpoint; "dots" = save matmul outputs
    remat_policy: str = "block"
    # selective scan: intermediate dtype (the port raises on True) + chunk
    # length (no counterpart in the port)
    ssm_bf16: bool = False
    ssm_chunk: int = 256
    # sequence-parallel activation constraints (read by nothing)
    sp_activations: bool = False
    # serving: params in bf16, replicated over dp below a footprint (read
    # by launch/specs.py)
    serve_bf16: bool = False
    serve_replicate_dp_below_gb: float = 0.0   # 0 = off


BASELINE = PerfConfig()

TUNED = PerfConfig(pv_bf16=False, additive_mask=True, flash_custom_vjp=True,
                   remat_policy="block", ssm_bf16=False, ssm_chunk=4096,
                   sp_activations=False,
                   serve_bf16=True, serve_replicate_dp_below_gb=10.0)

_local = threading.local()


def set_perf(cfg: PerfConfig) -> None:
    """The profile this thread's models run under."""
    _local.cfg = cfg


def get_perf() -> PerfConfig:
    """This thread's profile (``BASELINE`` until ``set_perf``)."""
    return getattr(_local, "cfg", BASELINE)

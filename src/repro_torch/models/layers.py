"""Building blocks shared by the port's models (the counterpart of
``repro/models/layers.py``, so far only what the Mamba path uses).

Parameters are stored float32 and cast to bfloat16 at each use; compute
runs in bfloat16 with float32 where the reference computes in float32
(the norm, the scan).
"""
from __future__ import annotations

import torch

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32


def _init(generator: torch.Generator, shape, scale: float | None = None,
          device=None) -> torch.Tensor:
    """Normal(0, 1) · ``scale`` (0.02 when None), float32, drawn from
    ``generator`` on ``device``."""
    scale = 0.02 if scale is None else scale
    out = torch.randn(shape, generator=generator, dtype=PARAM_DTYPE,
                      device=device)
    return out.mul_(scale)


def pad_to(x: int, m: int) -> int:
    return -(-x // m) * m


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm computed in float32, cast back to ``x``'s dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * w.float()
    return out.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x · (1 / (1 + exp(-x)))`` in ``x``'s dtype, each step rounded to
    it, as ``jax.nn.silu`` computes it. ``F.silu`` computes in float32 and
    rounds once, which often differs from it by one bfloat16 ulp."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return x * (one / (one + torch.exp(-x)))

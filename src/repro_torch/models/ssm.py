"""Mamba-1 selective-SSM block, the falcon-mamba mixer (the counterpart of
``repro/models/ssm.py``).

Training, prefill and decode all run the selective scan through
``kernels.ops.selective_scan``, the hand-written CUDA kernel on the card:
prefill from a zero state, keeping the final state for the cache; decode
with S = 1 from the cached state, the same recurrence as the reference's
O(1) decode update. Under autograd the scan is differentiable: its
forward keeps a state every ``ops.SCAN_CHUNK`` steps and its backward is
the hand-written ``selective_scan_bwd`` kernel (on the CPU, both run
their plain versions), where the reference differentiates its chunked
associative scan. Matmuls run in bfloat16 on float32 parameters, each
weight cast at its use; the scan runs in float32 (``perf.ssm_bf16``
raises: the kernels have no bfloat16 form).

On a live mesh (``sharding.env``) a rank holds d_inner / tp channels of
every mixer parameter (``in_proj`` its channels of x and of the gate, side
by side: ``param_halves``) and runs the block as a tensor-parallel region:
``x_proj`` contracts over d_inner, so its output (dt's rank, B and C) is
all-reduced over tp, and ``out_proj`` is row-split, so the block's output
is too; the conv, the scan and its backward kernel run on the rank's
channels unchanged, its state [B, d_inner / tp, N].
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, SsmConfig
from ..core import collectives as C
from ..kernels import ops
from ..sharding.env import place
from .layers import COMPUTE_DTYPE, PARAM_DTYPE, _init, silu, tp_region
from .perf import get_perf


def ssm_dims(cfg: ModelConfig) -> tuple[SsmConfig, int, int]:
    """(the SSM config, d_inner, dt_rank)."""
    s = cfg.ssm or SsmConfig()
    d_in = s.expand * cfg.d_model
    dt_rank = s.dt_rank or -(-cfg.d_model // 16)
    return s, d_in, dt_rank


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Shape of each mixer parameter, in the reference's orientation
    (``x @ w`` with ``w`` [in, out])."""
    s, d_in, dt_rank = ssm_dims(cfg)
    d = cfg.d_model
    return {"in_proj": (d, 2 * d_in), "conv_w": (s.d_conv, d_in),
            "conv_b": (d_in,), "x_proj": (d_in, dt_rank + 2 * s.d_state),
            "dt_proj": (dt_rank, d_in), "dt_bias": (d_in,),
            "a_log": (d_in, s.d_state), "d_skip": (d_in,),
            "out_proj": (d_in, d)}


def param_specs(cfg: ModelConfig) -> dict[str, tuple]:
    """Logical partition spec of each mixer parameter: d_inner over tp,
    the model dimension over fsdp."""
    return {"in_proj": ("fsdp", "tp"), "conv_w": (None, "tp"),
            "conv_b": ("tp",), "x_proj": ("tp", None),
            "dt_proj": (None, "tp"), "dt_bias": ("tp",),
            "a_log": ("tp", None), "d_skip": ("tp",),
            "out_proj": ("tp", "fsdp")}


#: Parameters whose last dimension is two halves split over tp apart.
param_halves = ("in_proj",)


def init_ssm(cfg: ModelConfig, generator: torch.Generator, repeats: int,
             device=None) -> dict[str, torch.Tensor]:
    """``repeats`` mixers' parameters, each stacked [R, ...], drawn as the
    reference draws them: normal·0.02 projections, ``conv_w`` ·0.2,
    ``dt_proj`` ·dt_rank^-0.5, ``out_proj`` ·0.02/√(2·n_layers), S4D-real
    ``a_log = log(1..N)``, and ``dt_bias`` the inverse softplus of a
    log-uniform step in [0.001, 0.1]. On a live mesh each is cut to this
    rank's shard as soon as it is drawn."""
    s, d_in, dt_rank = ssm_dims(cfg)
    shapes = {k: (repeats,) + v for k, v in param_shapes(cfg).items()}
    specs = param_specs(cfg)

    def normal(name, scale=None):
        return _placed(name, _init(generator, shapes[name], scale, device))

    def _placed(name, t):
        return place(t, (None,) + specs[name], halves=name in param_halves)

    u = torch.rand(shapes["dt_bias"], generator=generator, dtype=PARAM_DTYPE,
                   device=device)
    step = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    a_init = torch.arange(1, s.d_state + 1, dtype=PARAM_DTYPE, device=device)
    return {
        "in_proj": normal("in_proj"),
        "conv_w": normal("conv_w", 0.2),
        "conv_b": _placed("conv_b", torch.zeros(
            shapes["conv_b"], dtype=PARAM_DTYPE, device=device)),
        "x_proj": normal("x_proj"),
        "dt_proj": normal("dt_proj", dt_rank ** -0.5),
        "dt_bias": _placed("dt_bias",
                           torch.log(torch.expm1(step.clamp(min=1e-4)))),
        "a_log": _placed("a_log", torch.log(a_init).expand(
            shapes["a_log"]).contiguous()),
        "d_skip": _placed("d_skip", torch.ones(
            shapes["d_skip"], dtype=PARAM_DTYPE, device=device)),
        "out_proj": normal("out_proj", 0.02 / math.sqrt(2 * cfg.n_layers)),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``logaddexp(x, 0)``, the reference's formula
    (``F.softplus`` switches to ``x`` above a threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over x [B, S, C] with kernel w [K, C] and bias
    b [C]. With ``state`` ([B, K-1, C], the trailing inputs of the previous
    call) it runs in streaming mode. Returns (out [B, S, C], the new state:
    the last K-1 inputs, zero-padded in front)."""
    k = w.shape[0]
    if state is not None:
        xin = torch.cat([state.to(x.dtype), x], dim=1)
    else:
        xin = F.pad(x, (0, 0, k - 1, 0))
    new_state = xin[:, xin.shape[1] - (k - 1):, :].contiguous()
    s = x.shape[1]
    out = xin[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, k):
        out = out + xin[:, i:i + s, :] * w[i][None, None, :]
    return out + b[None, None, :], new_state


def ssm_block(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
              state: tuple[torch.Tensor, torch.Tensor] | None = None
              ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Mamba block over x [B, S, D] with one layer's parameters ``p``.

    ``state`` = (conv_state [B, K-1, Di] bf16, h [B, Di, N] f32) continues
    a sequence (decode); None starts one (prefill). Returns (y [B, S, D] in
    x's dtype, (new conv_state, new h)).
    """
    if get_perf().ssm_bf16:
        raise ValueError("perf ssm_bf16: the selective scan kernels run in "
                         "float32 only")
    s_cfg, _, dt_rank = ssm_dims(cfg)
    n = s_cfg.d_state
    tp = tp_region()
    xc = x.to(COMPUTE_DTYPE)
    if tp is not None:
        xc = C.copy_to_tp(xc, tp[0])
    d_in = p["in_proj"].shape[-1] // 2          # this rank's channels
    xz = xc @ p["in_proj"].to(COMPUTE_DTYPE)                    # [B,S,2Di]
    xi, z = xz[..., :d_in], xz[..., d_in:]

    conv_state = state[0] if state is not None else None
    xi, new_conv = causal_conv(xi, p["conv_w"].to(COMPUTE_DTYPE),
                               p["conv_b"].to(COMPUTE_DTYPE), conv_state)
    xi = silu(xi)

    proj = xi @ p["x_proj"].to(COMPUTE_DTYPE)                   # [B,S,R+2N]
    if tp is not None:   # a sum over every rank's channels, used by each
        proj = C.copy_to_tp(C.reduce_from_tp(proj, tp[0]), tp[0])
    dt_r = proj[..., :dt_rank]
    b_t = proj[..., dt_rank:dt_rank + n].float().contiguous()
    c_t = proj[..., dt_rank + n:].float().contiguous()
    dt = softplus((dt_r @ p["dt_proj"].to(COMPUTE_DTYPE)).float()
                  + p["dt_bias"][None, None, :])                # [B,S,Di]
    # exp in the parameters' dtype, then float32 for the kernel, as the
    # reference's promotions go with bfloat16 serving weights (a no-op on
    # float32 parameters)
    a = torch.exp(p["a_log"]).float()                           # positive
    h0 = state[1] if state is not None else None
    y, new_h = ops.selective_scan(xi.float(), dt, b_t, c_t, a,
                                  p["d_skip"].float(), h0)

    y = y.to(COMPUTE_DTYPE) * silu(z)
    out = y @ p["out_proj"].to(COMPUTE_DTYPE)
    if tp is not None:
        out = C.reduce_from_tp(out, tp[0])
    return out.to(x.dtype), (new_conv, new_h)

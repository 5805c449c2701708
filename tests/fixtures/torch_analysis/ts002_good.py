# analysis-virtual-path: engine/sweep.py
"""TS002 good: the Function's forward and backward and the checkpointed
body stay on the device; the host driver that calls ``apply`` or
``checkpoint`` is NOT traced and may sync freely after the dispatch."""
import numpy as np
import torch
from torch.utils.checkpoint import checkpoint


class _Sweep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, state, n):
        ctx.n = n                      # a Python int: no sync
        return state * torch.sum(state)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.n, None


def _body(state):
    return torch.where(state > 0, state, -state)


def driver(state):
    out = _Sweep.apply(state, 4)
    again = checkpoint(_body, out, use_reentrant=False)
    return np.asarray(again.detach().cpu()), float(out[0]), again.tolist()
